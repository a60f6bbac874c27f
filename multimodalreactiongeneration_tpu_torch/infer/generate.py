"""Autoregressive head-motion generation.

Counterpart of ``multimodalreactiongeneration_tpu/infer/generate.py``:
``generate_lws`` for LSTMwithSample (below) and ``generate_metaformer``
with the JAX package's three decode layouts:

  * hoisted shared-KV (the default, and the production path):
    1. One full-sequence pass encodes the known other-modality streams
       (audio, partner motion) for lead + seq (``encode_others_only``,
       without gradient; on the card one-layer LSTM encoder stacks run
       the mixer-stack kernel, K1, multi-layer LSTM mixers K9's layer
       route a block, GRU mixers K10 a layer a block, MLP mixers no
       kernel).
    2. The leading segment primes the shared raw rings and the main
       LSTM states (warmup, masks on).
    3. The rollout: prediction[t] = model(prev); the next prev is
       prediction[t] where sampling_mask[t] else motion_s[t]. With
       ``fused_rollout`` ("auto" or True, and a supported config) it is
       one call of ``ops/decode_rollout.decode_rollout`` (K2 on the
       card, its plain version on the CPU); ``fused_rollout=False``, a
       config outside the rollout's gate (a main mixer other than a
       one-layer LSTM: the GRU of configs/lstmformer_gru.yaml, an MLP,
       ``num_internal_layer`` above 1), or on the card a shape outside
       K2's contract (hidden other than 256, heads other than 4, ...)
       under "auto", runs the module step by step. Recurrent and MLP
       embeddings start from None states (an MLP carries none; a
       multi-layer recurrent mixer carries (layers, B, H) per block).
  * in-loop shared-KV (``hoist_encoders=False``, or "auto" with mha
    other-modality embeddings): the warmup primes block 0's encoders
    and the raw rings, and every step encodes its own ``ratio`` audio
    frames and partner-motion frame in block 0 (K1 over the lead's
    audio on the card; the 8-frame step chunks run the plain
    recurrences). ``StreamingSession`` and ``ServingEngine`` step this
    layout.
  * per-block (``kv_layout="per_block"``, and the fallback for
    ``repeat_with_encoder`` models and int8 caches): every (block,
    integrator, layer) keeps its own ring of projected K/V
    (``infer/cache.py cache_init``), attended with the plain attention,
    as in JAX; int8 rings hold per-token codes and scales.

-100 padded inputs are zeroed first. Tensors use the JAX package's
layouts.

``generate_lws`` and ``generate_metaformer`` run without gradient. Their
bodies, ``_generate_lws`` and ``_generate_metaformer``, run under the
caller's grad mode: the scheduled-sampling training step
(``train/harness.py``) takes the loss on their rollout with gradients
through it, the Metaformer's on the in-loop per-block f32 layout, as
JAX's step pins it. The model runs in eval mode there too (JAX's rollout
applies the model deterministically). The fused rollout (K2) has no
backward: asking for it under gradient raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from multimodalreactiongeneration_tpu_torch.infer.cache import (
    cache_init,
    raw_cache_init,
)
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    derived_sizes as lws_sizes,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    context_budgets,
    derived_sizes,
)

PADDING_VALUE = -100.0


def _zero_padding(x: torch.Tensor) -> torch.Tensor:
    return x * (x != PADDING_VALUE)


@contextlib.contextmanager
def eval_mode(model):
    """Run ``model`` in eval mode inside, and restore its own mode after:
    decode is deterministic, as the JAX decode is."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def _form_steps(fbank, motion_p, motion_s, ratio: int):
    """(B, L*r, F), (B, L, D), (B, L, D) -> per-step inputs
    (L, B, r, F), (L, B, 1, D), (L, B, 1, D)."""
    b, _, f = fbank.shape
    l = motion_p.shape[1]
    fb = fbank.reshape(b, l, ratio, f).permute(1, 0, 2, 3)
    mp = motion_p.permute(1, 0, 2)[:, :, None, :]
    ms = motion_s.permute(1, 0, 2)[:, :, None, :]
    return fb, mp, ms


def sampling_mask_for(
    length: int,
    mode: str,
    generator: Optional[torch.Generator] = None,
    rate: float = 0.0,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """"full" (all model), "teacher" (all ground truth), "scheduled"
    (Bernoulli(rate) per step, drawn from ``generator``)."""
    if mode == "full":
        return torch.ones(length, dtype=torch.bool, device=device)
    if mode == "teacher":
        return torch.zeros(length, dtype=torch.bool, device=device)
    if mode == "scheduled":
        if generator is None:
            raise ValueError("scheduled sampling needs a torch.Generator")
        draw = torch.rand(length, generator=generator,
                          device=generator.device)
        return (draw < rate).to(device)
    raise ValueError(f"unknown sampling mode {mode!r}")


@torch.no_grad()
def generate_lws(
    model,
    batch_data: Sequence[torch.Tensor],
    sampling_mask: torch.Tensor,
    carry_layerd_state: bool = True,
) -> torch.Tensor:
    """``_generate_lws`` without gradient."""
    return _generate_lws(model, batch_data, sampling_mask, carry_layerd_state)


def _generate_lws(
    model,
    batch_data: Sequence[torch.Tensor],
    sampling_mask: torch.Tensor,
    carry_layerd_state: bool = True,
) -> torch.Tensor:
    """Rollout for LSTMwithSample; ``batch_data`` is the 7-tuple (fbank_p,
    motion_p, motion_s, lead_fbank, lead_mp, lead_ms, target). Returns
    the prediction (B, L, D).

    A warmup pass over the leading segment primes the states (on the
    card the sampler's stacked LSTM runs its kernel there); then per step
    ``ratio`` audio frames, one partner-motion frame and the previous
    self-motion frame go through the model (all under 16 steps: the
    plain recurrences). ``carry_layerd_state=False`` drops the layered
    blocks' states after every call, the reference's effective behaviour
    (its LSTMLayerd returns the input states). The model runs in eval
    mode for the call, and its own mode is restored afterwards."""
    with eval_mode(model):
        fbank, motion_p, motion_s, lead_a, lead_mp, lead_ms, _ = [
            _zero_padding(x) for x in batch_data
        ]
        fb, mp, ms = _form_steps(fbank, motion_p, motion_s,
                                 lws_sizes(model.cfg)["ratio"])
        sampling_mask = sampling_mask.to(ms.device)

        def keep(state):
            return state if carry_layerd_state else (state[0], None)

        _, state = model(lead_a, lead_mp, lead_ms)
        state, prev, ys = keep(state), ms[0], []
        for t in range(ms.shape[0]):
            y, state = model(fb[t], mp[t], prev, None, None, None, state)
            state = keep(state)
            prev = torch.where(sampling_mask[t], y, ms[t])
            ys.append(y)
        return torch.stack(ys)[:, :, 0, :].transpose(0, 1)


def _init_metaformer_states(
    model_cfg: dict,
    batch: int,
    cache_dtype: torch.dtype = torch.bfloat16,
    kv_layout: str = "per_block",
    hoisted: bool = False,
    device: Optional[torch.device] = None,
):
    """Decode states: ring buffers sized by the per-modality context
    budgets; recurrent embedding states start None.

    kv_layout="per_block": one projected-K/V ring per (block, integrator,
    layer); works with repeat_with_encoder and int8 caches.
    kv_layout="shared": ONE raw ring per other modality holding block 0's
    pre-projection encodings, attended by every block with its
    projections folded (``TorchMHA.attend_raw``).
    hoisted: the other-modality encoders run outside the loop, so block 0
    carries only the main-modality embedding state, like later blocks.
    mha embeddings get rings of their own in either layout (without them
    a decode step would attend only itself)."""
    if kv_layout not in ("shared", "per_block"):
        raise ValueError(
            f"kv_layout must be 'shared' or 'per_block', got {kv_layout!r}"
        )
    if kv_layout == "shared" and model_cfg["repeat_with_encoder"]:
        raise ValueError(
            "kv_layout='shared' requires repeat_with_encoder=False; "
            "use kv_layout='per_block'"
        )
    if kv_layout == "shared" and cache_dtype == torch.int8:
        # a raw int8 ring would truncate float encodings with no scales
        raise ValueError(
            "kv_layout='shared' does not support int8 caches (per-slot "
            "quantization scales live in the per_block layout)"
        )
    if hoisted and kv_layout != "shared":
        raise ValueError("hoisted encoders require kv_layout='shared'")
    budgets = context_budgets(model_cfg)
    hidden = model_cfg["hidden_size"]
    num_layerd = model_cfg["num_layerd"]
    num_inner = model_cfg["num_internal_layer"]
    n_other = len(model_cfg["modalities"]) - 1
    emb_types = list(model_cfg["emb_mixers"])
    main_type = emb_types.pop(model_cfg["main_modal_idx"])
    other_modalities = list(model_cfg["modalities"])
    main_modality = other_modalities.pop(model_cfg["main_modal_idx"])
    # block-0 embedding order: [main] + others; later blocks main only
    emb_order = [(main_modality, main_type)] + list(
        zip(other_modalities, emb_types)
    )
    rates = {
        "audio": model_cfg["sampling_rate"] / model_cfg["shift"],
        "motion": model_cfg["pred_fps"],
    }

    def rings(count, capacity):
        return [cache_init(batch, capacity, hidden, dtype=cache_dtype,
                           device=device) for _ in range(count)]

    def emb_state(modality: str, mtype: str, layerd: int):
        if mtype != "mha":
            return None
        budget = int(model_cfg["max_context_len"] * rates[modality])
        return [rings(num_inner, budget) for _ in range(layerd)]

    states = []
    for b in range(model_cfg["num_block"]):
        encode = (b == 0 and not hoisted) or model_cfg["repeat_with_encoder"]
        emb_here = emb_order if encode else emb_order[:1]
        emb = [
            emb_state(modality, mtype,
                      num_layerd if m == 0 else model_cfg["encoder_num_layer"])
            for m, (modality, mtype) in enumerate(emb_here)
        ]
        if kv_layout == "shared":
            crm = [[None] * num_layerd for _ in range(n_other)]
        else:
            crm = [[rings(num_inner, budgets[i]) for _ in range(num_layerd)]
                   for i in range(n_other)]
        states.append({"emb": emb, "crm": crm})
    if kv_layout == "shared":
        return {
            "shared": [
                raw_cache_init(batch, budgets[i], hidden, cache_dtype, device)
                for i in range(n_other)
            ],
            "blocks": states,
        }
    return states


def _fused_rollout_supported(
    cfg: dict, cache_dtype, ratio: int, len_a0: int
) -> bool:
    """Config shapes the fused rollout handles (kept identical to the
    JAX package's gate, so both packages pick the same path)."""
    others = list(cfg["modalities"])
    others.pop(cfg["main_modal_idx"])
    budgets = context_budgets(cfg)
    sizes = derived_sizes(cfg)
    return (
        cfg["emb_mixers"][cfg["main_modal_idx"]] == "lstm"
        and cfg["num_layerd"] == 1
        and cfg["num_internal_layer"] == 1
        and cfg["nonlinearity"] in (None, "none")
        and cfg["ffn_nonlinearity"] == "relu"
        and bool(cfg["residual"])
        and bool(cfg["residual_layer_norm"])
        and bool(cfg["bias"])
        and not cfg["interlayer_residual"]
        and cache_dtype in (torch.bfloat16, torch.float32)
        and others == ["audio", "motion"]
        and cfg["hidden_size"] % cfg["num_heads"] == 0
        and ratio % 8 == 0
        and budgets[0] % ratio == 0
        and len_a0 % ratio == 0
        and sizes["motion_input_size"] <= 128
    )


def _rollout_route(cfg: dict, cache_dtype, fused_rollout, device_type: str,
                   ratio: int, len_a0: int) -> bool:
    """Whether the hoisted rollout goes to ``decode_rollout`` (True) or
    runs the module step by step (False), decided from shapes before any
    launch. ``fused_rollout`` False: the loop. Otherwise a config outside
    ``_fused_rollout_supported`` takes the loop under "auto" and raises
    under True. On the CPU a supported config takes ``decode_rollout``'s
    plain version; on the card K2 takes it only within the kernel's shape
    contract (``ops/decode_rollout.py kernel_contract``): "auto" takes the
    loop elsewhere, as JAX's "auto" falls back to its scan where its
    kernel does not fit, and True raises."""
    from multimodalreactiongeneration_tpu_torch.ops.decode_rollout import (
        kernel_contract,
    )

    supported = _fused_rollout_supported(cfg, cache_dtype, ratio, len_a0)
    if fused_rollout is True and not supported:
        raise ValueError(
            "fused_rollout=True but the model config is outside the "
            "fused rollout's contract (see ops/decode_rollout.py)"
        )
    if fused_rollout is False or not supported or device_type == "cpu":
        return fused_rollout is not False and supported
    budgets = context_budgets(cfg)
    why = kernel_contract(cfg["hidden_size"], cfg["num_heads"], budgets[0],
                          budgets[1], budgets[1], cfg["bottleneck_size"],
                          ratio, len_a0)
    if why and fused_rollout is True:
        raise ValueError(
            f"fused_rollout=True: the decode_rollout kernel {why}")
    return why is None


def _fused_rollout_args(
    model, states, enc_a_steps, enc_mp_steps, ms, sampling_mask,
    cache_dtype, len_a0: int, len_m0: int,
):
    """Positional and keyword arguments of ``decode_rollout`` for the
    post-priming rollout."""
    from multimodalreactiongeneration_tpu_torch.ops.decode_rollout import (
        fold_decode_params,
    )

    cfg = model.cfg
    heads = cfg["num_heads"]
    folded = fold_decode_params(model, cfg["num_block"], heads,
                                mm_dtype=cache_dtype)
    ca0 = states["shared"][0]["x"]
    cm0 = states["shared"][1]["x"]
    blocks = states["blocks"]
    h0 = torch.stack([blocks[l]["emb"][0][0][0][0]
                      for l in range(cfg["num_block"])]).float()
    c0 = torch.stack([blocks[l]["emb"][0][0][1][0]
                      for l in range(cfg["num_block"])]).float()
    w0, b0 = folded["emb0_w"], folded["emb0_b"]
    gt_emb = (ms[:, :, 0, :] @ w0 + b0).float()
    main0 = (ms[0][:, 0, :] @ w0 + b0).float()
    args = (
        folded,
        ca0.contiguous(),
        cm0.contiguous(),
        h0.contiguous(),
        c0.contiguous(),
        main0.contiguous(),
        enc_a_steps.to(ca0.dtype).contiguous(),
        enc_mp_steps[:, :, 0, :].to(cm0.dtype).contiguous(),
        gt_emb.contiguous(),
        sampling_mask.float().contiguous(),
    )
    kwargs = dict(heads=heads, ratio=enc_a_steps.shape[2], len_a0=len_a0,
                  len_m0=len_m0, bud_m=cm0.shape[1])
    return args, kwargs


def _fused_rollout(
    model, states, enc_a_steps, enc_mp_steps, ms, sampling_mask,
    cache_dtype, len_a0: int, len_m0: int,
) -> torch.Tensor:
    """Hand the post-priming rollout to ``decode_rollout``; (B, L, D)."""
    from multimodalreactiongeneration_tpu_torch.ops.decode_rollout import (
        decode_rollout,
    )

    args, kwargs = _fused_rollout_args(
        model, states, enc_a_steps, enc_mp_steps, ms, sampling_mask,
        cache_dtype, len_a0, len_m0,
    )
    return decode_rollout(*args, **kwargs).transpose(0, 1)


def _hoist_and_warmup(model, batch_data, cache_dtype):
    """Steps 1 and 2 of the hoisted path: the full-sequence encoder pass
    and the warmup over the leading segment. Returns (states,
    enc_a_steps (L, B, r, H), enc_mp_steps (L, B, 1, H), ms (L, B, 1, D),
    lead lengths la, lm)."""
    fbank, motion_p, motion_s, lead_a, lead_mp, lead_ms, _ = [
        _zero_padding(x) for x in batch_data
    ]
    cfg = model.cfg
    ratio = derived_sizes(cfg)["ratio"]
    batch = fbank.shape[0]
    hidden = cfg["hidden_size"]
    _, _, ms = _form_steps(fbank, motion_p, motion_s, ratio)

    # one full-sequence pass encodes every other-modality token the
    # rollout will attend
    full_a = torch.cat([lead_a, fbank], dim=1)
    full_mp = torch.cat([lead_mp, motion_p], dim=1)
    enc_a, enc_mp = model(full_a, full_mp, None, encode_others_only=True)
    la, lm = lead_a.shape[1], lead_mp.shape[1]
    steps = motion_s.shape[1]
    enc_a_steps = (
        enc_a[:, la:].reshape(batch, steps, ratio, hidden).permute(1, 0, 2, 3)
    )
    enc_mp_steps = enc_mp[:, lm:].permute(1, 0, 2)[:, :, None, :]

    states = _init_metaformer_states(cfg, batch, cache_dtype, "shared",
                                     hoisted=True, device=fbank.device)
    _, states = model(
        lead_a, lead_mp, lead_ms, states=states, use_masks=True,
        precomputed_others=[enc_a[:, :la], enc_mp[:, :lm]],
    )
    return states, enc_a_steps, enc_mp_steps, ms, la, lm


@torch.no_grad()
def generate_metaformer(
    model,
    batch_data: Sequence[torch.Tensor],
    sampling_mask: torch.Tensor,
    cache_dtype: torch.dtype = torch.bfloat16,
    kv_layout: str = "shared",
    hoist_encoders="auto",
    fused_rollout="auto",
) -> torch.Tensor:
    """``_generate_metaformer`` without gradient."""
    return _generate_metaformer(model, batch_data, sampling_mask,
                                cache_dtype, kv_layout, hoist_encoders,
                                fused_rollout)


def _generate_metaformer(
    model,
    batch_data: Sequence[torch.Tensor],
    sampling_mask: torch.Tensor,
    cache_dtype: torch.dtype = torch.bfloat16,
    kv_layout: str = "shared",
    hoist_encoders="auto",
    fused_rollout="auto",
) -> torch.Tensor:
    """Rollout for the Metaformer; ``batch_data`` is the 7-tuple
    (fbank_p, motion_p, motion_s, lead_fbank, lead_mp, lead_ms, target).
    Returns the prediction (B, L, D).

    kv_layout: "shared" (the default) or "per_block"; "shared" falls back
    to "per_block" for repeat_with_encoder models and int8 caches, as in
    JAX. hoist_encoders: "auto" hoists whenever the layout is shared and
    no other-modality embedding is mha; True requires it; False runs the
    encoders in the loop. fused_rollout (hoisted path only): "auto" takes
    ``decode_rollout`` whenever the config is supported (bf16 and f32
    caches alike) and, on the card, within K2's shape contract; True
    requires both; False runs the module step by step
    (``_rollout_route``).

    The model runs in eval mode for the call (``eval_mode``)."""
    with eval_mode(model):
        return _generate(model, batch_data, sampling_mask, cache_dtype,
                         kv_layout, hoist_encoders, fused_rollout)


def _generate(model, batch_data, sampling_mask, cache_dtype, kv_layout,
              hoist_encoders, fused_rollout):
    cfg = model.cfg
    if kv_layout == "shared" and (
        cfg["repeat_with_encoder"] or cache_dtype == torch.int8
    ):
        # the shared layout needs block-0 encoding reuse, and quantized
        # rings carry their scales only in the per-block layout
        kv_layout = "per_block"
    other_types = list(cfg["emb_mixers"])
    other_types.pop(cfg["main_modal_idx"])
    hoistable = kv_layout == "shared" and all(t != "mha" for t in other_types)
    if hoist_encoders == "auto":
        hoist = hoistable
    else:
        hoist = bool(hoist_encoders)
        if hoist and not hoistable:
            raise ValueError(
                "hoist_encoders=True needs the shared KV layout and "
                "non-mha other-modality embeddings "
                f"(kv_layout={kv_layout!r}, emb types {other_types})"
            )
    if fused_rollout is True and not hoist:
        raise ValueError(
            "fused_rollout=True needs the hoisted shared-KV path "
            f"(kv_layout={kv_layout!r}, hoist_encoders={hoist_encoders!r})"
        )
    if not hoist:
        return _generate_in_loop(model, batch_data, sampling_mask,
                                 cache_dtype, kv_layout)

    states, enc_a_steps, enc_mp_steps, ms, la, lm = _hoist_and_warmup(
        model, batch_data, cache_dtype
    )
    ratio = enc_a_steps.shape[2]
    sampling_mask = sampling_mask.to(ms.device)

    if _rollout_route(cfg, cache_dtype, fused_rollout, ms.device.type,
                      ratio, la):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "the fused rollout (decode_rollout, K2) has no backward: "
                "under gradient pass fused_rollout=False, or "
                "kv_layout='per_block' as the scheduled-sampling step does")
        return _fused_rollout(
            model, states, enc_a_steps, enc_mp_steps, ms, sampling_mask,
            cache_dtype, la, lm,
        )

    prev, st = ms[0], states
    ys = []
    for t in range(ms.shape[0]):
        y, st = model(
            None, None, prev, states=st, use_masks=False,
            precomputed_others=[enc_a_steps[t], enc_mp_steps[t]],
        )
        prev = torch.where(sampling_mask[t], y, ms[t])
        ys.append(y)
    return torch.stack(ys)[:, :, 0, :].transpose(0, 1)


def _generate_in_loop(model, batch_data, sampling_mask, cache_dtype,
                      kv_layout):
    """The non-hoisted layouts: a warmup over the leading segment with
    the rings attached (masks on: its outputs feed deeper blocks'
    recurrent states), then one module step a frame on ``ratio`` audio
    frames, one partner-motion frame and the previous self-motion
    frame; block 0 (every block with repeat_with_encoder) runs the
    encoders in the loop."""
    fbank, motion_p, motion_s, lead_a, lead_mp, lead_ms, _ = [
        _zero_padding(x) for x in batch_data
    ]
    fb, mp, ms = _form_steps(fbank, motion_p, motion_s,
                             derived_sizes(model.cfg)["ratio"])
    states = _init_metaformer_states(model.cfg, fbank.shape[0], cache_dtype,
                                     kv_layout, device=fbank.device)
    _, st = model(lead_a, lead_mp, lead_ms, states=states, use_masks=True)
    sampling_mask = sampling_mask.to(ms.device)
    prev, ys = ms[0], []
    for t in range(ms.shape[0]):
        y, st = model(fb[t], mp[t], prev, states=st, use_masks=False)
        prev = torch.where(sampling_mask[t], y, ms[t])
        ys.append(y)
    return torch.stack(ys)[:, :, 0, :].transpose(0, 1)
