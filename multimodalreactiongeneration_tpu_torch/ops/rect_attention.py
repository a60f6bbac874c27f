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
"""

from __future__ import annotations

import ctypes
import math

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops.lstm_bf16 import round_bf16

NEG_INF = -1e30
HEAD_DIMS = (32, 64)

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def rect_attention_mask(q_pad: torch.Tensor, k_pad: torch.Tensor
                        ) -> torch.Tensor:
    """(B, Lq, Lk) bool: the rect-causal mask OR the pad pairs."""
    lq, lk = q_pad.shape[1], k_pad.shape[1]
    i = torch.arange(lq, device=q_pad.device)[:, None]
    j = torch.arange(lk, device=q_pad.device)[None, :]
    causal = j * lq >= (i + 1) * lk
    return causal[None] | (q_pad[:, :, None] & k_pad[:, None, :])


def rect_attention_reference(heads, q, k, v, q_pad, k_pad) -> torch.Tensor:
    """Plain PyTorch version; arguments as ``rect_attention``. The masked
    f32 softmax of ``nn/attention.py scaled_dot_attention`` on the merged
    mask, heads split and merged around it."""
    return _merge(_weights(heads, q, k, q_pad, k_pad)[0] @ _heads(heads, v))


def _heads(heads, x):
    """(B, L, E) -> (B, heads, L, Dh) f32."""
    b, n, e = x.shape
    return x.float().reshape(b, n, heads, e // heads).transpose(1, 2)


def _merge(x):
    """(B, heads, L, Dh) -> (B, L, E)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _weights(heads, q, k, q_pad, k_pad):
    """The f32 softmax weights (B, heads, Lq, Lk) and the mask: logits of
    q and k (in the bf16 mode their bf16 values) with f32 sums, masked to
    -1e30."""
    mask = rect_attention_mask(q_pad, k_pad)[:, None]
    logits = _heads(heads, q) @ _heads(heads, k).transpose(-1, -2) * (
        1.0 / math.sqrt(q.shape[-1] // heads))
    return torch.softmax(logits.masked_fill(mask, NEG_INF), dim=-1), mask


class _PlainBf16Attention(torch.autograd.Function):
    """JAX's bf16-mode kernels written out (``pallas_rect_attention.py
    _fwd_kernel`` and ``_bwd_kernel``): forward bf16(w) bf16(v); backward
    from g rounded to bf16, dw = bf16(g) v^T, ds = w (dw - rowsum(dw w))
    (zero where masked), dq = bf16(ds) k * scale, dk = bf16(ds)^T q *
    scale, dv = bf16(w)^T bf16(g), each rounded to bf16."""

    @staticmethod
    def forward(ctx, heads, q, k, v, q_pad, k_pad):
        w, _ = _weights(heads, q, k, q_pad, k_pad)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, q_pad, k_pad)
        return _merge(round_bf16(w) @ _heads(heads, v))

    @staticmethod
    def backward(ctx, g):
        heads = ctx.heads
        q, k, v, q_pad, k_pad = ctx.saved_tensors
        w, mask = _weights(heads, q, k, q_pad, k_pad)
        gr = round_bf16(_heads(heads, g))
        dw = gr @ _heads(heads, v).transpose(-1, -2)
        ds = w * (dw - (dw * w).sum(-1, keepdim=True))
        ds = round_bf16(ds.masked_fill(mask, 0.0))
        scale = 1.0 / math.sqrt(q.shape[-1] // heads)
        dq = ds @ _heads(heads, k) * scale
        dk = ds.transpose(-1, -2) @ _heads(heads, q) * scale
        dv = round_bf16(w).transpose(-1, -2) @ gr
        return (None, *(_merge(d).to(torch.bfloat16) for d in (dq, dk, dv)),
                None, None)


def rect_attention_bf16_reference(heads, q, k, v, q_pad, k_pad):
    """Plain PyTorch version of the bf16 mode (bf16 q, k, v; f32 context),
    differentiable at JAX's rounding points (``_PlainBf16Attention``)."""
    return _PlainBf16Attention.apply(heads, q, k, v, q_pad, k_pad)


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
        lib.rect_attention_forward_f32.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.rect_attention_backward_f32.argtypes = (
            [_P] * 14 + [_I] * 5 + [_P])
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
        lib.rect_attention_forward_bf16.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        lib.rect_attention_backward_bf16.argtypes = (
            [_P] * 12 + [_I] * 5 + [_P])
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
    ``rect_attention`` documents, head dim 32 or 64. Returns (B, Lq, Lk, E,
    bf16 mode)."""
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
    if e % heads or e // heads not in HEAD_DIMS:
        raise ValueError(
            f"{name} kernel takes head dims {HEAD_DIMS}; got E={e}, "
            f"heads={heads}")
    return b, lq, lk, e, mm == torch.bfloat16


def rect_attention_forward(heads, q, k, v, q_pad, k_pad, residuals=False):
    """The forward kernel (CUDA only) of the operands' mode. Returns the
    f32 context (B, Lq, E) and, with ``residuals``, also each row's
    softmax max and sum (B, H, Lq), which ``rect_attention_backward``
    reads."""
    b, lq, lk, e, bf16 = _check_args("rect_attention_forward", heads, q, k,
                                     v, q_pad, k_pad)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty(b, lq, e, **f32)
    m = l = None
    if residuals:
        m, l = torch.empty(b, heads, lq, **f32), torch.empty(b, heads, lq,
                                                             **f32)
    fn = (_lib_bf16().rect_attention_forward_bf16 if bf16
          else _lib().rect_attention_forward_f32)
    _build.launch(fn, q, k, v, q_pad, k_pad, out, m, l,
                  dims=(b, lq, lk, e, heads))
    global fwd_launches, bf16_fwd_launches
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return (out, m, l) if residuals else out


def backward_workspace_bytes(heads, b, lq, lk, e):
    """Bytes of the dQ workspace the backward kernel takes at these shapes
    (each key block's partial dQ for the query rows that see its keys)."""
    n = _lib().rect_attention_backward_workspace_floats(b, lq, lk, e, heads)
    if n < 0:
        raise ValueError(
            f"rect_attention_backward: no kernel for B={b}, Lq={lq}, "
            f"Lk={lk}, E={e}, heads={heads}")
    return 4 * n


def bf16_backward_workspace_bytes(heads, b, lq, lk, e):
    """Bytes of the scratch the bf16 backward takes at these shapes: the
    rows' D, bf16(g) and the dQ workspace (each key block's partial dQ
    for the query rows that see its keys)."""
    n = _lib_bf16().rect_attention_bf16_backward_workspace_bytes(
        b, lq, lk, e, heads)
    if n < 0:
        raise ValueError(
            f"rect_attention_backward (bf16): no kernel for B={b}, Lq={lq}, "
            f"Lk={lk}, E={e}, heads={heads}")
    return n


def rect_attention_backward(heads, q, k, v, q_pad, k_pad, out, m, l, g):
    """The backward kernels (CUDA only) of the operands' mode, from the
    forward's context and residuals and the context's cotangent ``g``.
    Returns (dq, dk, dv) in the operands' dtype."""
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
    if g.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        g = g.clone()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if bf16:
        scratch = torch.empty(bf16_backward_workspace_bytes(heads, b, lq, lk,
                                                            e),
                              dtype=torch.uint8, device=q.device)
        _build.launch(_lib_bf16().rect_attention_backward_bf16, q, k, v,
                      q_pad, k_pad, g, m, l, dq, dk, dv, scratch,
                      dims=(b, lq, lk, e, heads))
        global bf16_bwd_launches
        bf16_bwd_launches += 1
        return dq, dk, dv
    d = q.new_empty(b, heads, lq)
    ws = q.new_empty(backward_workspace_bytes(heads, b, lq, lk, e) // 4)
    _build.launch(_lib().rect_attention_backward_f32, q, k, v, q_pad, k_pad,
                  out, g, m, l, dq, dk, dv, d, ws,
                  dims=(b, lq, lk, e, heads))
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


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
