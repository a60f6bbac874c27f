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

``rect_attention`` is the entry point. On CPU tensors it runs
``rect_attention_reference`` (autograd records through it). On CUDA
tensors, where a gradient is needed, the autograd function runs the
forward kernel with its softmax residuals and the backward kernels;
otherwise the forward kernel alone, which writes no residuals. Both
launch ``csrc/rect_attention.cu`` (f32 only; every product on the tensor
cores in 3xTF32; the design is in its source note). The backward takes a
dQ workspace (``backward_workspace_bytes``: each key block's partial dQ
for the query rows that see its keys) from PyTorch's allocator on the
caller's stream. Launch counters: ``fwd_launches`` (one per forward call)
and ``bwd_launches`` (one per backward call, which runs the source's
three backward kernels in turn: D, the key-block pass, the dQ sum).
"""

from __future__ import annotations

import ctypes
import math

import torch

from multimodalreactiongeneration_tpu_torch import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64)

fwd_launches = 0
bwd_launches = 0

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
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // heads

    def split(x, n):
        return x.float().reshape(b, n, heads, dh).transpose(1, 2)

    logits = split(q, lq) @ split(k, lk).transpose(-1, -2) * (
        1.0 / math.sqrt(dh))
    logits = logits.masked_fill(rect_attention_mask(q_pad, k_pad)[:, None],
                                NEG_INF)
    ctx = torch.softmax(logits, dim=-1) @ split(v, lk)
    return ctx.transpose(1, 2).reshape(b, lq, e)


def rect_attention_backward_reference(heads, q, k, v, q_pad, k_pad, g,
                                      closure=False):
    """Plain backward: ``torch.autograd.grad`` of the plain forward.
    Returns (dq, dk, dv); with ``closure=True``, a function that computes
    them again and again from the graph recorded once, so the backward
    can be timed alone."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = rect_attention_reference(heads, *leaves, q_pad, k_pad)

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


def _check_args(name, heads, q, k, v, q_pad, k_pad):
    """The kernels' contract: contiguous f32 q/k/v and bool pads on one
    CUDA device, shapes as ``rect_attention`` documents, head dim 32 or
    64."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    b, lq, e = q.shape
    lk = k.shape[1]
    for x, shape, dtype in ((q, (b, lq, e), torch.float32),
                            (k, (b, lk, e), torch.float32),
                            (v, (b, lk, e), torch.float32),
                            (q_pad, (b, lq), torch.bool),
                            (k_pad, (b, lk), torch.bool)):
        if x.device != q.device or x.dtype != dtype:
            raise ValueError(
                f"{name} kernel takes f32 q/k/v and bool pads on one CUDA "
                f"device (bf16 operands wait for bf16 training); got "
                f"{x.dtype} on {x.device}"
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
    return b, lq, lk, e


def rect_attention_forward(heads, q, k, v, q_pad, k_pad, residuals=False):
    """The forward kernel (CUDA only). Returns the context (B, Lq, E) and,
    with ``residuals``, also each row's softmax max and sum (B, H, Lq),
    which ``rect_attention_backward`` reads."""
    b, lq, lk, e = _check_args("rect_attention_forward", heads, q, k, v,
                               q_pad, k_pad)
    out = torch.empty_like(q)
    m = l = None
    if residuals:
        m = q.new_empty(b, heads, lq)
        l = q.new_empty(b, heads, lq)
    _build.launch(_lib().rect_attention_forward_f32, q, k, v, q_pad, k_pad,
                  out, m, l, dims=(b, lq, lk, e, heads))
    global fwd_launches
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


def rect_attention_backward(heads, q, k, v, q_pad, k_pad, out, m, l, g):
    """The backward kernels (CUDA only), from the forward's context and
    residuals and the context's cotangent ``g``. Returns (dq, dk, dv)."""
    b, lq, lk, e = _check_args("rect_attention_backward", heads, q, k, v,
                               q_pad, k_pad)
    g = g.float().contiguous()
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(
            f"rect_attention_backward: cotangent {tuple(g.shape)} on "
            f"{g.device} for {tuple(q.shape)} on {q.device}")
    if g.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        g = g.clone()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
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
    differentiable in q, k and v. CPU tensors take the plain version;
    CUDA tensors the kernels (forward with residuals and backward where a
    gradient is needed, the forward alone otherwise)."""
    if q.device.type == "cpu":
        return rect_attention_reference(heads, q, k, v, q_pad, k_pad)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _RectAttention.apply(heads, q, k, v, q_pad, k_pad)
    return rect_attention_forward(heads, q, k, v, q_pad, k_pad)
