"""Autoregressive head-motion generation for the Metaformer.

Counterpart of ``generate_metaformer`` in ``multimodalreactiongeneration
_tpu/infer/generate.py`` on its production branch: the hoisted-encoder,
shared-KV path.

  1. One full-sequence pass encodes the known other-modality streams
     (audio, partner motion) for lead + seq (``encode_others_only``; on
     the card the encoder stacks run the mixer-stack kernel).
  2. The leading segment primes the shared raw rings and the main LSTM
     states (warmup, masks on).
  3. The rollout: prediction[t] = model(prev); the next prev is
     prediction[t] where sampling_mask[t] else motion_s[t]. With
     ``fused_rollout`` ("auto" or True, and a supported config) it is
     one call of ``ops/decode_rollout.decode_rollout`` (the kernel on
     the card, its plain version on the CPU); ``fused_rollout=False``
     runs the module step by step.

-100 padded inputs are zeroed first. Tensors use the JAX package's
layouts. The per-block KV layout, int8 caches and the in-loop
(non-hoisted) encoder path are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from multimodalreactiongeneration_tpu_torch.infer.cache import raw_cache_init
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    context_budgets,
    derived_sizes,
)

PADDING_VALUE = -100.0


def _zero_padding(x: torch.Tensor) -> torch.Tensor:
    return x * (x != PADDING_VALUE)


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


def _init_metaformer_states(
    model_cfg: dict,
    batch: int,
    cache_dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
):
    """Shared-KV decode states with hoisted encoders: one raw ring per
    other modality, sized by the context budgets; every block carries
    only its main-modality embedding state (None until warmup)."""
    if model_cfg["repeat_with_encoder"]:
        raise ValueError("the shared-KV layout requires repeat_with_encoder=False")
    if cache_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"shared-KV caches are f32 or bf16, got {cache_dtype}"
        )
    budgets = context_budgets(model_cfg)
    hidden = model_cfg["hidden_size"]
    n_other = len(model_cfg["modalities"]) - 1
    num_layerd = model_cfg["num_layerd"]
    main_type = model_cfg["emb_mixers"][model_cfg["main_modal_idx"]]
    if main_type == "mha":
        raise NotImplementedError(
            "mha main-modality embeddings need per-block caches, which "
            "are not ported"
        )
    blocks = [
        {"emb": [None], "crm": [[None] * num_layerd for _ in range(n_other)]}
        for _ in range(model_cfg["num_block"])
    ]
    return {
        "shared": [
            raw_cache_init(batch, budgets[i], hidden, cache_dtype, device)
            for i in range(n_other)
        ],
        "blocks": blocks,
    }


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
    """Steps 1 and 2: the full-sequence encoder pass and the warmup over
    the leading segment. Returns (states, enc_a_steps (L, B, r, H),
    enc_mp_steps (L, B, 1, H), ms (L, B, 1, D), lead lengths la, lm)."""
    fbank, motion_p, motion_s, lead_a, lead_mp, lead_ms, _ = [
        _zero_padding(x) for x in batch_data
    ]
    cfg = model.cfg
    other_types = list(cfg["emb_mixers"])
    other_types.pop(cfg["main_modal_idx"])
    if cfg["repeat_with_encoder"] or any(t == "mha" for t in other_types):
        raise NotImplementedError(
            "only the hoisted shared-KV decode path is ported "
            "(repeat_with_encoder=False, non-mha other-modality embeddings)"
        )
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

    states = _init_metaformer_states(cfg, batch, cache_dtype, fbank.device)
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
    fused_rollout="auto",
) -> torch.Tensor:
    """Rollout for the Metaformer; ``batch_data`` is the 7-tuple
    (fbank_p, motion_p, motion_s, lead_fbank, lead_mp, lead_ms, target).
    Returns the prediction (B, L, D).

    fused_rollout: "auto" takes ``decode_rollout`` whenever the config
    is supported (bf16 and f32 caches alike); True requires it; False
    runs the module step by step."""
    cfg = model.cfg
    states, enc_a_steps, enc_mp_steps, ms, la, lm = _hoist_and_warmup(
        model, batch_data, cache_dtype
    )
    ratio = enc_a_steps.shape[2]
    sampling_mask = sampling_mask.to(ms.device)

    supported = _fused_rollout_supported(cfg, cache_dtype, ratio, la)
    if fused_rollout is True and not supported:
        raise ValueError(
            "fused_rollout=True but the model config is outside the "
            "fused rollout's contract (see ops/decode_rollout.py)"
        )
    if fused_rollout is not False and supported:
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
