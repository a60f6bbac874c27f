"""Rectangular-causal multi-head attention: CUDA kernels, autograd and
plain version.

Counterpart of ``rect_attention`` in ``multimodalreactiongeneration_tpu/
ops/pallas_rect_attention.py``, with the same signature and layouts:
q (B, Lq, E), k and v (B, Lk, E) in the projection layout, bool pads
(B, Lq) and (B, Lk), True = padding frame; the result is the f32 context
(B, Lq, E), ready for the output projection. Key j is masked for query i
iff ``j*Lq >= (i+1)*Lk`` or both are padding; masked logits take the
finite -1e30, so a row whose keys are all masked is the uniform average
over all Lk keys (PARITY #4).

Two operand modes, by JAX's off-TPU rule (``_operand_dtype``): bf16 when
q is bf16, else f32; k and v are cast to it (so an f32 q with bf16 k and
v, as the bf16 Metaformer's later blocks give it, runs the f32 mode on
k and v converted exactly, and autograd rounds their f32 gradients to
bf16). The context is f32 in both; dq, dk and dv come back in q's, k's
and v's dtypes. The bf16 mode is JAX's kernel on bf16 operands: bf16
products with f32 sums, the softmax in f32, the normalized weights
rounded to bf16 for the context; the backward rounds the cotangent, and
ds, to bf16 for the products (``rect_attention_bf16_reference`` writes
it out).

``rect_attention`` is the entry point. On CPU tensors it runs the plain
versions (f32: autograd records through ``rect_attention_reference``;
bf16: ``rect_attention_bf16_reference``). On CUDA tensors, where a
gradient is needed, the autograd function runs the forward kernel with
its softmax residuals (each row's max and sum) and the backward kernels;
otherwise the forward kernel alone, which writes no residuals. The f32
mode launches ``csrc/rect_attention.cu`` (every product on the tensor
cores in 3xTF32), the bf16 mode ``csrc/attention_bf16.cu`` (bf16
``mma.sync`` products over streamed key tiles, JAX's normalized weights
rounded); their designs are in their source notes. Each backward takes
its scratch from PyTorch's allocator on the caller's stream: the f32
mode's dQ workspace (``backward_workspace_bytes``: each key block's
partial dQ for the query rows that see its keys), the bf16 mode's the
same workspace beside the rows' D and bf16(g)
(``bf16_backward_workspace_bytes``). Launch counters, one per call of a
mode's forward or backward (each backward runs its source's three
kernels in turn: D, the key-block pass, the dQ sum): ``fwd_launches``
and ``bwd_launches`` (f32), ``bf16_fwd_launches`` and
``bf16_bwd_launches``.

Head dims: the kernels are built for head dims 16, 32, 64, 128 and 256
(``HEAD_DIMS``, the tiles), as JAX's kernel takes any head dim. Any other
head dim d up to 256 runs on the next tile up, ``padded_head_dim(d)``:
the wrappers of the kernels (``rect_attention_forward`` and
``rect_attention_backward``) copy q, k and v (and, backward, the context
and its cotangent) once into that width, each head's d columns followed
by zero columns (``pad_heads``), launch the kernel with the logits'
scale of the real d, 1/sqrt(d), and drop the padded columns of what
comes back (``unpad_heads``). That is exact: zero columns add nothing to
q.k, and the padded columns of the context and of dq, dk and dv are
dropped. One padded copy in the wrapper rather than masked loads in the
kernels keeps every kernel's copies 16 bytes wide and its tiles whole;
its cost is a copy of the operands each call (``PERF.md``). A head dim
above 256 raises on CUDA, naming K5/K6 (``kernel_refusal``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops.lstm_bf16 import round_bf16

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are built for

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def rect_attention_mask(q_pad: torch.Tensor, k_pad: torch.Tensor
                        ) -> torch.Tensor:
    """(B, Lq, Lk) bool: the rect-causal mask OR the pad pairs."""
    lq, lk = q_pad.shape[1], k_pad.shape[1]
    i = torch.arange(lq, device=q_pad.device)[:, None]
    j = torch.arange(lk, device=q_pad.device)[None, :]
    causal = j * lq >= (i + 1) * lk
    return causal[None] | (q_pad[:, :, None] & k_pad[:, None, :])


def rect_attention_reference(heads, q, k, v, q_pad, k_pad,
                             scale=None) -> torch.Tensor:
    """Plain PyTorch version; arguments as ``rect_attention``. The masked
    f32 softmax of ``nn/attention.py scaled_dot_attention`` on the merged
    mask, heads split and merged around it. ``scale``: the logits' factor,
    by default 1/sqrt of the head dim (a caller that padded the heads
    passes the real head dim's)."""
    return _merge(_weights(heads, q, k, q_pad, k_pad, scale)[0]
                  @ _heads(heads, v))


def padded_head_dim(d: int):
    """The kernels' tile for head dim d: the least of ``HEAD_DIMS`` that is
    at least d, or None above 256."""
    return next((t for t in HEAD_DIMS if t >= d), None)


def pad_heads(x: torch.Tensor, heads: int, dp: int) -> torch.Tensor:
    """(B, L, heads * d) -> (B, L, heads * dp), each head's d columns
    followed by dp - d zero columns (a new contiguous tensor; x itself
    when d is dp)."""
    b, n, e = x.shape
    d = e // heads
    if d == dp:
        return x
    out = x.new_zeros(b, n, heads, dp)
    out[..., :d] = x.view(b, n, heads, d)
    return out.view(b, n, heads * dp)


def unpad_heads(x: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """The inverse of ``pad_heads``: each head's first d columns,
    contiguous (x itself when there is no padding)."""
    b, n, e = x.shape
    dp = e // heads
    if d == dp:
        return x
    return x.view(b, n, heads, dp)[..., :d].reshape(b, n, heads * d)


def kernel_refusal(e: int, heads: int):
    """Why the K5/K6 kernels cannot take E columns in ``heads`` heads, or
    None: every head dim from 1 to 256 runs (on its ``padded_head_dim``
    tile)."""
    if heads < 1 or e % heads:
        return f"E={e} in {heads} heads: E must split into whole heads"
    d = e // heads
    if not 1 <= d <= HEAD_DIMS[-1]:
        return (f"head dim {d} (E={e}, heads={heads}): the K5/K6 kernels "
                f"take head dims 1 to {HEAD_DIMS[-1]} (tiles {HEAD_DIMS}, "
                "the others padded with zero columns to the next tile)")
    return None


def _heads(heads, x):
    """(B, L, E) -> (B, heads, L, Dh) f32."""
    b, n, e = x.shape
    return x.float().reshape(b, n, heads, e // heads).transpose(1, 2)


def _merge(x):
    """(B, heads, L, Dh) -> (B, L, E)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _scale(heads, q, scale):
    """The logits' factor: ``scale``, or 1/sqrt of q's head dim."""
    return 1.0 / math.sqrt(q.shape[-1] // heads) if scale is None else scale


def _weights(heads, q, k, q_pad, k_pad, scale=None):
    """The f32 softmax weights (B, heads, Lq, Lk) and the mask: logits of
    q and k (in the bf16 mode their bf16 values) with f32 sums, times
    ``_scale``, masked to -1e30."""
    mask = rect_attention_mask(q_pad, k_pad)[:, None]
    logits = _heads(heads, q) @ _heads(heads, k).transpose(-1, -2) * (
        _scale(heads, q, scale))
    return torch.softmax(logits.masked_fill(mask, NEG_INF), dim=-1), mask


class _PlainBf16Attention(torch.autograd.Function):
    """JAX's bf16-mode kernels written out (``pallas_rect_attention.py
    _fwd_kernel`` and ``_bwd_kernel``): forward bf16(w) bf16(v); backward
    from g rounded to bf16, dw = bf16(g) v^T, ds = w (dw - rowsum(dw w))
    (zero where masked), dq = bf16(ds) k * scale, dk = bf16(ds)^T q *
    scale, dv = bf16(w)^T bf16(g), each rounded to bf16."""

    @staticmethod
    def forward(ctx, heads, q, k, v, q_pad, k_pad, scale):
        w, _ = _weights(heads, q, k, q_pad, k_pad, scale)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, q_pad, k_pad)
        return _merge(round_bf16(w) @ _heads(heads, v))

    @staticmethod
    def backward(ctx, g):
        heads = ctx.heads
        q, k, v, q_pad, k_pad = ctx.saved_tensors
        w, mask = _weights(heads, q, k, q_pad, k_pad, ctx.scale)
        gr = round_bf16(_heads(heads, g))
        dw = gr @ _heads(heads, v).transpose(-1, -2)
        ds = w * (dw - (dw * w).sum(-1, keepdim=True))
        ds = round_bf16(ds.masked_fill(mask, 0.0))
        scale = _scale(heads, q, ctx.scale)
        dq = ds @ _heads(heads, k) * scale
        dk = ds.transpose(-1, -2) @ _heads(heads, q) * scale
        dv = round_bf16(w).transpose(-1, -2) @ gr
        return (None, *(_merge(d).to(torch.bfloat16) for d in (dq, dk, dv)),
                None, None, None)


def rect_attention_bf16_reference(heads, q, k, v, q_pad, k_pad, scale=None):
    """Plain PyTorch version of the bf16 mode (bf16 q, k, v; f32 context),
    differentiable at JAX's rounding points (``_PlainBf16Attention``);
    ``scale`` as ``rect_attention_reference``'s."""
    return _PlainBf16Attention.apply(heads, q, k, v, q_pad, k_pad, scale)


def _plain(q):
    """The plain version of q's operand mode."""
    return (rect_attention_bf16_reference if q.dtype == torch.bfloat16
            else rect_attention_reference)


def operand_dtype(q, k, v) -> torch.dtype:
    """JAX's off-TPU operand rule: bf16 when q is bf16, else f32 (k and v
    are cast to it); raises for other dtypes."""
    for x in (q, k, v):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"rect_attention (K5/K6) takes f32 or bf16 q, k, v; got "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
    return q.dtype


def rect_attention_backward_reference(heads, q, k, v, q_pad, k_pad, g,
                                      closure=False):
    """Plain backward: ``torch.autograd.grad`` of the plain forward of the
    operands' mode. Returns (dq, dk, dv); with ``closure=True``, a
    function that computes them again and again from the graph recorded
    once, so the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = _plain(q)(heads, *leaves, q_pad, k_pad)

    def grads():
        return torch.autograd.grad(out, leaves, g, retain_graph=closure)
    return grads if closure else grads()


def _lib():
    lib = _build.load("rect_attention")
    if not getattr(lib, "_typed", False):
        lib.rect_attention_forward_f32.argtypes = (
            [_P] * 8 + [_I] * 5 + [_F, _P])
        lib.rect_attention_backward_f32.argtypes = (
            [_P] * 14 + [_I] * 5 + [_F, _P])
        lib.rect_attention_backward_workspace_floats.argtypes = [_I] * 5
        lib.rect_attention_forward_f32.restype = ctypes.c_int
        lib.rect_attention_backward_f32.restype = ctypes.c_int
        lib.rect_attention_backward_workspace_floats.restype = (
            ctypes.c_longlong)
        lib._typed = True
    return lib


def _lib_bf16():
    lib = _build.load("attention_bf16")
    if not getattr(lib, "_typed", False):
        lib.rect_attention_forward_bf16.argtypes = (
            [_P] * 8 + [_I] * 5 + [_F, _P])
        lib.rect_attention_backward_bf16.argtypes = (
            [_P] * 12 + [_I] * 5 + [_F, _P])
        lib.rect_attention_bf16_backward_workspace_bytes.argtypes = [_I] * 5
        lib.rect_attention_forward_bf16.restype = ctypes.c_int
        lib.rect_attention_backward_bf16.restype = ctypes.c_int
        lib.rect_attention_bf16_backward_workspace_bytes.restype = (
            ctypes.c_longlong)
        lib._typed = True
    return lib


def _check_args(name, heads, q, k, v, q_pad, k_pad):
    """The kernels' contract: contiguous q/k/v of one dtype (f32, or bf16
    for the bf16 mode) and bool pads on one CUDA device, shapes as
    ``rect_attention`` documents, head dim 1 to 256 (``kernel_refusal``).
    Returns (B, Lq, Lk, E, bf16 mode)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    b, lq, e = q.shape
    lk = k.shape[1]
    mm = q.dtype
    for x, shape, dtype in ((q, (b, lq, e), mm), (k, (b, lk, e), mm),
                            (v, (b, lk, e), mm), (q_pad, (b, lq), torch.bool),
                            (k_pad, (b, lk), torch.bool)):
        if (x.device != q.device or x.dtype != dtype
                or mm not in (torch.float32, torch.bfloat16)):
            raise ValueError(
                f"{name} kernel takes q/k/v all f32 or all bf16 and bool "
                f"pads on one CUDA device; got {x.dtype} on {x.device} "
                f"beside q {mm}"
            )
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {shape}, got {tuple(x.shape)} "
                f"(contiguous={x.is_contiguous()})"
            )
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(
            f"{name}: q, k and v must start on 16-byte boundaries (the "
            f"forward copies them 16 bytes at a time)")
    why = kernel_refusal(e, heads)
    if why is not None:
        raise ValueError(f"{name}: no K5/K6 kernel for {why}")
    return b, lq, lk, e, mm == torch.bfloat16


def _tile(heads, e):
    """(head dim, its tile, the tile's E, the logits' scale)."""
    d = e // heads
    dp = padded_head_dim(d)
    return d, dp, heads * dp, 1.0 / math.sqrt(d)


def rect_attention_forward(heads, q, k, v, q_pad, k_pad, residuals=False):
    """The forward kernel (CUDA only) of the operands' mode, at a head dim
    that is no tile on q, k and v padded to the next (``pad_heads``).
    Returns the f32 context (B, Lq, E) and, with ``residuals``, also each
    row's softmax max and sum (B, H, Lq), which
    ``rect_attention_backward`` reads."""
    b, lq, lk, e, bf16 = _check_args("rect_attention_forward", heads, q, k,
                                     v, q_pad, k_pad)
    d, dp, ep, scale = _tile(heads, e)
    q, k, v = (pad_heads(x, heads, dp) for x in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty(b, lq, ep, **f32)
    m = l = None
    if residuals:
        m, l = torch.empty(b, heads, lq, **f32), torch.empty(b, heads, lq,
                                                             **f32)
    fn = (_lib_bf16().rect_attention_forward_bf16 if bf16
          else _lib().rect_attention_forward_f32)
    _build.launch(fn, q, k, v, q_pad, k_pad, out, m, l,
                  dims=(b, lq, lk, ep, heads, scale))
    global fwd_launches, bf16_fwd_launches
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    out = unpad_heads(out, heads, d)
    return (out, m, l) if residuals else out


def _tile_e(heads, e):
    """E of the kernels' tile for E columns in ``heads`` heads (E itself
    where there is none: the library refuses it)."""
    dp = padded_head_dim(e // heads) if heads > 0 and e % heads == 0 else None
    return e if dp is None else heads * dp


def backward_workspace_bytes(heads, b, lq, lk, e):
    """Bytes of the dQ workspace the backward kernel takes at these shapes
    (each key block's partial dQ for the query rows that see its keys, at
    the head dim's tile)."""
    n = _lib().rect_attention_backward_workspace_floats(
        b, lq, lk, _tile_e(heads, e), heads)
    if n < 0:
        raise ValueError(
            f"rect_attention_backward: no kernel for B={b}, Lq={lq}, "
            f"Lk={lk}, E={e}, heads={heads}")
    return 4 * n


def bf16_backward_workspace_bytes(heads, b, lq, lk, e):
    """Bytes of the scratch the bf16 backward takes at these shapes: the
    rows' D, bf16(g) and the dQ workspace (each key block's partial dQ
    for the query rows that see its keys), at the head dim's tile."""
    n = _lib_bf16().rect_attention_bf16_backward_workspace_bytes(
        b, lq, lk, _tile_e(heads, e), heads)
    if n < 0:
        raise ValueError(
            f"rect_attention_backward (bf16): no kernel for B={b}, Lq={lq}, "
            f"Lk={lk}, E={e}, heads={heads}")
    return n


def rect_attention_backward(heads, q, k, v, q_pad, k_pad, out, m, l, g):
    """The backward kernels (CUDA only) of the operands' mode, from the
    forward's context and residuals and the context's cotangent ``g``; at
    a head dim that is no tile, on q, k, v, the context and ``g`` padded
    to the next (``pad_heads``). Returns (dq, dk, dv) in the operands'
    dtype."""
    b, lq, lk, e, bf16 = _check_args("rect_attention_backward", heads, q, k,
                                     v, q_pad, k_pad)
    if m is None or l is None:
        raise ValueError("rect_attention_backward: needs the forward's row "
                         "max and sum (rect_attention_forward(..., "
                         "residuals=True))")
    g = g.float().contiguous()
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(
            f"rect_attention_backward: cotangent {tuple(g.shape)} on "
            f"{g.device} for {tuple(q.shape)} on {q.device}")
    d, dp, ep, scale = _tile(heads, e)
    q, k, v, g = (pad_heads(x, heads, dp) for x in (q, k, v, g))
    if g.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        g = g.clone()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if bf16:
        scratch = torch.empty(bf16_backward_workspace_bytes(heads, b, lq, lk,
                                                            e),
                              dtype=torch.uint8, device=q.device)
        _build.launch(_lib_bf16().rect_attention_backward_bf16, q, k, v,
                      q_pad, k_pad, g, m, l, dq, dk, dv, scratch,
                      dims=(b, lq, lk, ep, heads, scale))
        global bf16_bwd_launches
        bf16_bwd_launches += 1
    else:
        out = pad_heads(out.float().contiguous(), heads, dp)
        rows = q.new_empty(b, heads, lq)
        ws = q.new_empty(backward_workspace_bytes(heads, b, lq, lk, e) // 4)
        _build.launch(_lib().rect_attention_backward_f32, q, k, v, q_pad,
                      k_pad, out, g, m, l, dq, dk, dv, rows, ws,
                      dims=(b, lq, lk, ep, heads, scale))
        global bwd_launches
        bwd_launches += 1
    return tuple(unpad_heads(x, heads, d) for x in (dq, dk, dv))


class _RectAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, q, k, v, q_pad, k_pad):
        out, m, l = rect_attention_forward(heads, q, k, v, q_pad, k_pad,
                                           residuals=True)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, q_pad, k_pad, out, m, l)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = rect_attention_backward(ctx.heads, *ctx.saved_tensors, g)
        return None, dq, dk, dv, None, None


def rect_attention(heads: int, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, q_pad: torch.Tensor,
                   k_pad: torch.Tensor) -> torch.Tensor:
    """Rect-causal multi-head attention in the projection layout,
    differentiable in q, k and v; q's dtype picks the operand mode (k and
    v are cast to it). CPU tensors take the plain versions; CUDA tensors
    the kernels (forward with residuals and backward where a gradient is
    needed, the forward alone otherwise)."""
    mm = operand_dtype(q, k, v)
    k, v = k.to(mm), v.to(mm)
    if q.device.type == "cpu":
        return _plain(q)(heads, q, k, v, q_pad, k_pad)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RectAttention.apply(heads, q, k, v, q_pad, k_pad)
    return rect_attention_forward(heads, q, k, v, q_pad, k_pad)
