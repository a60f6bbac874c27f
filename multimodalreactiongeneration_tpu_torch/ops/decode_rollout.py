"""The hoisted AR decode rollout: CUDA kernel, plain version, weight fold.

Counterpart of ``multimodalreactiongeneration_tpu/ops/pallas_decode_rollout.py``
(``decode_rollout`` and ``fold_decode_params``), same contract. Per
step: write the step's precomputed audio / partner-motion encodings into
the shared raw rings; per metaformer block run the main LSTM cell,
LN/FF/LN, two folded attends over the rings (each followed by LN/FF/LN),
cat and the block FFN; then the output head, and feed back the
prediction's embedding blended with the teacher embedding by the
sampling mask.

Weight folding (exact reassociations of ``TorchMHA.attend_raw``):
  q-side   W~q[:, h] = W_q^T[:, h] @ W_k[h]   (the k-bias cancels)
  out-side W~o[h]    = W_v[h]^T @ W_out^T[h],  b~o = b_v @ W_out^T + b_out
  feedback W_fb      = W_out2 @ W_emb0,        b_fb = b_out2 @ W_emb0 + b_emb0

``decode_rollout`` launches ``csrc/decode_rollout.cu`` for CUDA tensors
(its design is in the source note) and runs ``decode_rollout_reference``
for CPU tensors; ``logit_chunk`` sizes the ring chunks of the kernel's
logits stage. ``launches`` counts kernel launches. Numerics: f32 state,
LayerNorms, softmax and sums; matmul inputs rounded to the panel dtype;
queries and softmax weights rounded to the ring dtype; masked logits at
-1e30.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict

import torch

from multimodalreactiongeneration_tpu_torch.nn.basic import layer_norm

launches = 0

NEG = -1e30
BATCH_PER_LAUNCH = 16
_KERNEL_HIDDEN = 256
_KERNEL_HEADS = 4
_KERNEL_MAX_RING = 2048
_MAX_CHUNKS = 32  # per ring: one lane per chunk merges the statistics

_W_KEYS = [
    "wih", "whh", "bg", "ln1g", "ln1b", "wef", "bef", "ln2g", "ln2b",
    "wqa", "bqa", "woa", "boa", "lnag", "lnab", "wfa", "bfa",
    "lnfag", "lnfab",
    "wqm", "bqm", "wom", "bom", "lnmg", "lnmb", "wfm", "bfm",
    "lnfmg", "lnfmb",
    "wcat", "bcat", "w1", "b1", "w2", "b2", "lnfg", "lnfb",
    "wo1", "bo1", "wo2", "bo2", "wfb", "bfb",
]


@torch.no_grad()
def fold_decode_params(model, num_blocks: int, heads: int,
                       mm_dtype: torch.dtype = torch.bfloat16
                       ) -> Dict[str, Any]:
    """Stack and fold the Metaformer decode weights into kernel layout.

    ``model`` is the port's ``Metaformer``. Returns (num_blocks, ...)
    stacks with matmul panels in (in, out) layout at ``mm_dtype``;
    biases and LayerNorm parameters stay f32. ``emb0_w`` / ``emb0_b``
    (host-side embedding of the teacher frames) and ``out_dim`` ride
    along."""
    mf = model.metaformer
    H = mf.feature_embedding_0.weight.shape[0]
    dh = H // heads

    def kern(lin):  # Dense kernel, flax (in, out) layout
        return lin.weight.T.float()

    def fold_q(mha):
        wq_t = mha.q_proj_weight.T.float()
        wk = mha.k_proj_weight.float()
        bq = mha.q_proj_bias.float()
        cols = [wq_t[:, h * dh:(h + 1) * dh] @ wk[h * dh:(h + 1) * dh]
                for h in range(heads)]
        bcols = [bq[h * dh:(h + 1) * dh] @ wk[h * dh:(h + 1) * dh]
                 for h in range(heads)]
        return torch.cat(cols, dim=1), torch.cat(bcols)

    def fold_o(mha):
        wv = mha.v_proj_weight.float()
        wo_t = mha.out_proj_weight.T.float()
        rows = [wv[h * dh:(h + 1) * dh].T @ wo_t[h * dh:(h + 1) * dh]
                for h in range(heads)]
        bo = mha.v_proj_bias.float() @ wo_t + mha.out_proj_bias.float()
        return torch.cat(rows, dim=0), bo

    stacks: Dict[str, list] = {}

    def put(name, x):
        stacks.setdefault(name, []).append(x.float())

    for l in range(num_blocks):
        bl = getattr(mf, f"block_{l}")
        emb = bl.emb_0.block_0
        put("wih", emb.mixer.weight_ih_l0.T)
        put("whh", emb.mixer.weight_hh_l0.T)
        put("bg", emb.mixer.bias_ih_l0 + emb.mixer.bias_hh_l0)
        put("ln1g", emb.mixer_norm.weight)
        put("ln1b", emb.mixer_norm.bias)
        put("wef", kern(emb.feed_forward.feedforward))
        put("bef", emb.feed_forward.feedforward.bias)
        put("ln2g", emb.feed_forward.LayerNorm_0.weight)
        put("ln2b", emb.feed_forward.LayerNorm_0.bias)
        for tag, idx in (("a", 0), ("m", 1)):
            g = getattr(bl, f"integrate_{idx}").block_0
            wq, bq = fold_q(g.mha_0)
            wo, bo = fold_o(g.mha_0)
            put(f"wq{tag}", wq)
            put(f"bq{tag}", bq)
            put(f"wo{tag}", wo)
            put(f"bo{tag}", bo)
            put(f"ln{tag}g", g.mixer_norm.weight)
            put(f"ln{tag}b", g.mixer_norm.bias)
            put(f"wf{tag}", kern(g.feed_forward.feedforward))
            put(f"bf{tag}", g.feed_forward.feedforward.bias)
            put(f"lnf{tag}g", g.feed_forward.LayerNorm_0.weight)
            put(f"lnf{tag}b", g.feed_forward.LayerNorm_0.bias)
        put("wcat", kern(bl.cat_linear))
        put("bcat", bl.cat_linear.bias)
        put("w1", kern(bl.feed_forward.input))
        put("b1", bl.feed_forward.input.bias)
        put("w2", kern(bl.feed_forward.output))
        put("b2", bl.feed_forward.output.bias)
        put("lnfg", bl.feed_forward.LayerNorm_0.weight)
        put("lnfb", bl.feed_forward.LayerNorm_0.bias)

    folded: Dict[str, Any] = {k: torch.stack(v) for k, v in stacks.items()}
    out_ff = mf.output_ff
    wo2 = kern(out_ff.output)  # (bottleneck, out_dim)
    bo2 = out_ff.output.bias.float()
    w0 = kern(mf.feature_embedding_0)  # (out_dim, H)
    b0 = mf.feature_embedding_0.bias.float()
    folded["wo1"] = kern(out_ff.input)
    folded["bo1"] = out_ff.input.bias.float()
    folded["wo2"] = wo2
    folded["bo2"] = bo2
    folded["wfb"] = wo2 @ w0
    folded["bfb"] = bo2 @ w0 + b0
    folded["emb0_w"] = w0.detach()
    folded["emb0_b"] = b0.detach()
    for k in _W_KEYS:  # matmul panels at mm_dtype; the rest f32
        v = folded[k].detach().to(
            mm_dtype if k.startswith("w") else torch.float32)
        folded[k] = v.contiguous()
    folded["out_dim"] = wo2.shape[1]
    return folded


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with x rounded to w's dtype, accumulated in f32."""
    return x.to(w.dtype).float() @ w.float()


def decode_rollout_reference(
    folded, ca0, cm0, h0, c0, main0, enc_a_steps, enc_m_steps, gt_emb,
    mask_f, *, heads: int, ratio: int, len_a0: int, len_m0: int,
    bud_m: int,
) -> torch.Tensor:
    """Plain PyTorch version; arguments as ``decode_rollout``."""
    f = folded
    ca, cm = ca0.clone(), cm0.clone()
    h, c = h0.float().clone(), c0.float().clone()
    x = main0.float()
    steps, batch = enc_a_steps.shape[:2]
    sa, hidden = ca.shape[1], ca.shape[2]
    scale = 1.0 / math.sqrt(hidden // heads)
    cols = torch.arange(max(sa, cm.shape[1]), device=ca.device)

    def attend(y, cache, vis, wq, bq, wo, bo):
        qh = (_mm(y, wq) + bq).reshape(batch, heads, hidden)
        logits = torch.einsum(
            "bhk,bsk->bhs", qh.to(cache.dtype).float(), cache.float()
        ) * scale
        logits = logits.masked_fill(cols[:cache.shape[1]] >= vis, NEG)
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum(
            "bhs,bsk->bhk", w.to(cache.dtype).float(), cache.float()
        )
        return _mm(ctx.reshape(batch, heads * hidden), wo) + bo

    ys = []
    for t in range(steps):
        off_a = (len_a0 + t * ratio) % sa
        ca[:, off_a:off_a + ratio] = enc_a_steps[t].to(ca.dtype)
        cm[:, (len_m0 + t) % bud_m] = enc_m_steps[t].to(cm.dtype)
        vis_a = min(len_a0 + (t + 1) * ratio, sa)
        vis_m = min(len_m0 + t + 1, bud_m)
        for l in range(h.shape[0]):
            gates = _mm(x, f["wih"][l]) + _mm(h[l], f["whh"][l]) + f["bg"][l]
            i_g, f_g, g_g, o_g = gates.chunk(4, dim=-1)
            c2 = torch.sigmoid(f_g) * c[l] + torch.sigmoid(i_g) * torch.tanh(g_g)
            h2 = torch.sigmoid(o_g) * torch.tanh(c2)
            h[l], c[l] = h2, c2
            y = layer_norm(h2 + x, f["ln1g"][l], f["ln1b"][l])
            y = layer_norm(_mm(y, f["wef"][l]) + f["bef"][l] + y,
                           f["ln2g"][l], f["ln2b"][l])
            outs = []
            for tag, cache, vis in (("a", ca, vis_a), ("m", cm, vis_m)):
                att = attend(y, cache, vis, f[f"wq{tag}"][l], f[f"bq{tag}"][l],
                             f[f"wo{tag}"][l], f[f"bo{tag}"][l])
                z = layer_norm(att + y, f[f"ln{tag}g"][l], f[f"ln{tag}b"][l])
                z = layer_norm(_mm(z, f[f"wf{tag}"][l]) + f[f"bf{tag}"][l] + z,
                               f[f"lnf{tag}g"][l], f[f"lnf{tag}b"][l])
                outs.append(z)
            wcat = f["wcat"][l]
            merged = (_mm(outs[0], wcat[:hidden]) + _mm(outs[1], wcat[hidden:])
                      + f["bcat"][l])
            ff = torch.relu(_mm(merged, f["w1"][l]) + f["b1"][l])
            x = layer_norm(_mm(ff, f["w2"][l]) + f["b2"][l] + merged,
                           f["lnfg"][l], f["lnfb"][l])
        o1 = torch.relu(_mm(x, f["wo1"]) + f["bo1"])
        ys.append(_mm(o1, f["wo2"]) + f["bo2"])
        pred = _mm(o1, f["wfb"]) + f["bfb"]
        m = mask_f[t]
        x = m * pred + (1.0 - m) * gt_emb[t]
    return torch.stack(ys)


def logit_chunk(sa: int, sm: int, grid: int,
                bt: int = BATCH_PER_LAUNCH) -> int:
    """Ring slots per work unit of the kernel's logits stage (S4): each
    of ``bt`` dialogs splits its audio ring (``sa`` slots) and motion ring
    (``sm``) into chunks of this size, one unit per chunk, on ``grid``
    blocks. A unit costs a fixed part (the query, the statistics) and
    a part per slot, so the chunk (a multiple of 8, each ring in at most
    32 chunks) takes the fewest rounds of units per block, then the
    fewest slots. At the flagship's rings (1000, 125) on 132 blocks: 144
    (8 chunks per dialog, 128 units, one round) where 128 gives 144
    units and a second round."""
    if grid < 1 or bt < 1 or not 0 < max(sa, sm) <= _KERNEL_MAX_RING:
        raise ValueError(
            f"logit_chunk: rings of 1 to {_KERNEL_MAX_RING} slots on at "
            f"least one block (got {sa}, {sm}, grid {grid}, bt {bt})")
    best = None
    for cs in range(8, _KERNEL_MAX_RING + 8, 8):
        na, nm = -(-sa // cs), -(-sm // cs)
        if max(na, nm) > _MAX_CHUNKS:
            continue
        cost = (-(-bt * (na + nm) // grid), cs)
        if best is None or cost < best[0]:
            best = (cost, cs)
    return best[1]


def _lib(defines=()):
    """The kernel's library; ``defines`` names a variant build (a
    measuring tool's instrumented one), never asked for here."""
    from multimodalreactiongeneration_tpu_torch import _build

    lib = _build.load("decode_rollout", defines)
    if not getattr(lib, "_typed", False):
        lib.decode_rollout_launch.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 15
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.decode_rollout_launch.restype = ctypes.c_int
        lib.decode_rollout_workspace_floats.argtypes = [ctypes.c_int] * 5
        lib.decode_rollout_workspace_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check(name, x, device, dtype, shape):
    if x.device != device or x.dtype != dtype:
        raise ValueError(
            f"decode_rollout kernel: {name} must be {dtype} on {device}, "
            f"got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(
            f"decode_rollout kernel: {name} must be contiguous {tuple(shape)},"
            f" got {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )


def decode_rollout(
    folded: Dict[str, Any],
    ca0: torch.Tensor,          # (B, SA, H) ring dtype
    cm0: torch.Tensor,          # (B, SM, H) ring dtype, SM >= bud_m
    h0: torch.Tensor,           # (NB, B, H) f32
    c0: torch.Tensor,           # (NB, B, H) f32
    main0: torch.Tensor,        # (B, H) f32, embedded first input
    enc_a_steps: torch.Tensor,  # (T, B, ratio, H) ring dtype
    enc_m_steps: torch.Tensor,  # (T, B, H) ring dtype
    gt_emb: torch.Tensor,       # (T, B, H) f32, embedded teacher frames
    mask_f: torch.Tensor,       # (T,) f32, 1.0 = model sample
    *,
    heads: int,
    ratio: int,
    len_a0: int,
    len_m0: int,
    bud_m: int,
) -> torch.Tensor:
    """Run the rollout; returns (T, B, out_dim) f32. The caller's rings
    are not modified."""
    args = (folded, ca0, cm0, h0, c0, main0, enc_a_steps, enc_m_steps,
            gt_emb, mask_f)
    kw = dict(heads=heads, ratio=ratio, len_a0=len_a0, len_m0=len_m0,
              bud_m=bud_m)
    tensors = [*args[1:], *(v for v in folded.values()
                            if isinstance(v, torch.Tensor))]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "decode_rollout has no backward; call it under torch.no_grad() "
            "or on tensors that do not require grad"
        )
    if ca0.device.type == "cpu":
        return decode_rollout_reference(*args, **kw)
    if ca0.device.type != "cuda":
        raise ValueError(f"decode_rollout: no kernel for {ca0.device}")

    dev, rdt = ca0.device, ca0.dtype
    steps, batch = enc_a_steps.shape[:2]
    nb = h0.shape[0]
    sa, hidden = ca0.shape[1], ca0.shape[2]
    sm = cm0.shape[1]
    bneck = folded["wo1"].shape[1]
    out_dim = int(folded["out_dim"])
    if rdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_rollout kernel: ring dtype {rdt} not taken")
    if hidden != _KERNEL_HIDDEN or heads != _KERNEL_HEADS:
        raise ValueError(
            f"decode_rollout kernel takes hidden {_KERNEL_HIDDEN} and "
            f"{_KERNEL_HEADS} heads; got {hidden} and {heads}"
        )
    if max(sa, sm) > _KERNEL_MAX_RING or bud_m > sm or bneck % 64:
        raise ValueError(
            f"decode_rollout kernel: rings up to {_KERNEL_MAX_RING} slots "
            f"(got {sa}, {sm}; bud_m {bud_m}) and a bottleneck that is a "
            f"multiple of 64 (got {bneck})"
        )
    if sa % ratio or len_a0 % ratio:
        raise ValueError(
            "decode_rollout kernel: the audio ring and its primed length "
            f"must be ratio multiples (SA {sa}, len_a0 {len_a0}, "
            f"ratio {ratio})"
        )
    _check("ca0", ca0, dev, rdt, (batch, sa, hidden))
    _check("cm0", cm0, dev, rdt, (batch, sm, hidden))
    _check("h0", h0, dev, torch.float32, (nb, batch, hidden))
    _check("c0", c0, dev, torch.float32, (nb, batch, hidden))
    _check("main0", main0, dev, torch.float32, (batch, hidden))
    _check("enc_a_steps", enc_a_steps, dev, rdt,
           (steps, batch, ratio, hidden))
    _check("enc_m_steps", enc_m_steps, dev, rdt, (steps, batch, hidden))
    _check("gt_emb", gt_emb, dev, torch.float32, (steps, batch, hidden))
    _check("mask_f", mask_f, dev, torch.float32, (steps,))
    weights = [folded[k] for k in _W_KEYS]
    for k, w in zip(_W_KEYS, weights):
        want = rdt if k.startswith("w") else torch.float32
        if w.device != dev or w.dtype != want or not w.is_contiguous():
            raise ValueError(
                f"decode_rollout kernel: folded[{k!r}] must be contiguous "
                f"{want} on {dev}, got {w.dtype} on {w.device}"
            )

    lib = _lib()
    chunk = logit_chunk(
        sa, sm, torch.cuda.get_device_properties(dev).multi_processor_count)
    ring_a, ring_m = ca0.clone(), cm0.clone()  # updated in place
    ys = torch.empty(steps, batch, out_dim, dtype=torch.float32, device=dev)
    ws = torch.empty(
        lib.decode_rollout_workspace_floats(nb, sa, sm, bneck, chunk),
        dtype=torch.float32, device=dev,
    )
    wptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = 1.0 / math.sqrt(hidden // heads)
    global launches
    with torch.cuda.device(dev):
        for b0 in range(0, batch, BATCH_PER_LAUNCH):
            bt = min(BATCH_PER_LAUNCH, batch - b0)
            bar = torch.zeros(2, dtype=torch.int32, device=dev)
            rc = lib.decode_rollout_launch(
                ctypes.cast(wptrs, ctypes.c_void_p),
                enc_a_steps.data_ptr(), enc_m_steps.data_ptr(),
                gt_emb.data_ptr(), mask_f.data_ptr(),
                ring_a.data_ptr(), ring_m.data_ptr(),
                h0.data_ptr(), c0.data_ptr(), main0.data_ptr(),
                ys.data_ptr(), ws.data_ptr(), bar.data_ptr(),
                int(rdt == torch.bfloat16), steps, batch, b0, bt, nb, bneck,
                out_dim, sa, sm, chunk, ratio, len_a0, len_m0, bud_m, scale,
                stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"decode_rollout kernel launch failed: CUDA error {rc}"
                )
            launches += 1
    return ys
