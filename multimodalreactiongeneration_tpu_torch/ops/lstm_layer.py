"""One LSTM layer (input projection + recurrence): CUDA kernels, autograd
and plain version.

Counterpart of ``lstm_layer`` in ``multimodalreactiongeneration_tpu/ops/
pallas_lstm.py``, same signature and layouts: ``x`` (B, T, din),
``w_ih_t`` (din, 4H) = W_ih^T, ``b_sum`` (4H,) = b_ih + b_hh, ``w_hh_t``
(H, 4H) = W_hh^T, ``h0``/``c0`` (B, H); gate order i, f, g, o. Returns
(ys (B, T, H), (h_n, c_n)).

Two operand modes, as JAX's ``lstm_layer`` documents them: every
tensor f32, or JAX's bf16 mode, where the weights' dtype selects the
products' operands: ``x``, ``w_ih_t`` and ``w_hh_t`` bf16, ``b_sum``,
``h0`` and ``c0`` f32 (``ops/lstm_bf16.py`` says what each product
rounds). In both, ys, h_n and c_n are f32; in the bf16 mode dx comes
back bf16 (x's dtype), dW_ih and dW_hh bf16 (the weights'), db and the
state cotangents f32. Any other mix of dtypes raises.

On CPU tensors ``lstm_layer`` runs ``lstm_layer_reference`` (f32:
autograd records through it; bf16: its backward is the plain bf16
backward). On CUDA tensors it computes xw = x W_ih^T + b with one FP32
``torch.addmm`` (as JAX leaves it to XLA; in the bf16 mode on x and
W_ih converted to f32, which is exact, so xw is JAX's f32 product of
bf16 operands) and launches ``csrc/lstm_layer.cu`` (H 128 or 256, din a
multiple of 4; the f32 or the bf16 instantiation): where a gradient is
needed, the forward that stores the backward's residuals and then the
backward kernel; otherwise the forward without residuals. Each chain
runs R batch rows per cluster, the smallest R the card holds in one wave
(``cluster_rows.choose_rows``; the bf16 chains need less shared memory,
so their layout is their own), or the ``rows`` a caller names. Launch
counters: ``fwd_launches`` (both f32 forwards), ``bwd_launches``,
``bf16_fwd_launches`` and ``bf16_bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops import lstm_bf16
from multimodalreactiongeneration_tpu_torch.ops.cluster_rows import (
    card_layout,
    resolve_rows,
)
from multimodalreactiongeneration_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence_reference,
)

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0

_MAX_H = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


def operand_dtype(name, args) -> torch.dtype:
    """The operand mode of (x, w_ih_t, b_sum, w_hh_t, h0, c0): f32 when
    every tensor is f32, bf16 for JAX's bf16 mode (x and both weights
    bf16, b_sum, h0 and c0 f32); raises, naming ``name``, otherwise."""
    mm = args[3].dtype
    want = (mm, mm, torch.float32, mm, torch.float32, torch.float32)
    if mm not in (torch.float32, torch.bfloat16) or any(
            a.dtype != d for a, d in zip(args, want)):
        raise ValueError(
            f"{name} (K7) takes every tensor f32, or x, w_ih_t and w_hh_t "
            "bf16 with b_sum, h0 and c0 f32 (the bf16 operand mode); got "
            + ", ".join(str(a.dtype) for a in args))
    return mm


def _bf16_forward(x, w_ih_t, b_sum, w_hh_t, h0, c0):
    """The plain bf16 mode: (ys, hn, cn, acts, cs), all f32."""
    b, t, din = x.shape
    xw = torch.addmm(b_sum, x.reshape(b * t, din).float(), w_ih_t.float())
    return lstm_bf16.chain_forward(xw.view(b, t, -1), w_hh_t, h0, c0)


def _bf16_backward(args, ys, acts, cs, dys, dhn, dcn):
    """The plain bf16 mode's gradients (dx, dw_ih_t, db_sum, dw_hh_t,
    dh0, dc0) from the forward's residuals."""
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    dgates, dh0, dc0 = lstm_bf16.chain_backward(
        acts, cs, c0, w_hh_t, dys.float(), dhn.float(), dcn.float())
    dx = lstm_bf16.round_bf16(dgates) @ w_ih_t.float().T
    return (dx.to(x.dtype), lstm_bf16.tn(x, dgates), dgates.sum((0, 1)),
            lstm_bf16.tn(lstm_bf16.shifted(ys, h0), dgates), dh0, dc0)


class _PlainBf16Layer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, cn, acts, cs = _bf16_forward(*args)
        ctx.save_for_backward(*args, ys, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        *args, ys, acts, cs = ctx.saved_tensors
        return _bf16_backward(args, ys, acts, cs, *lstm_bf16.zero_none(
            (dys, dhn, dcn), (ys, args[4], args[5])))


def lstm_layer_reference(x, w_ih_t, b_sum, w_hh_t, h0, c0):
    """Plain PyTorch version: the projection for the whole sequence is one
    matmul, only h @ W_hh^T runs inside the time loop. In the bf16 mode
    (bf16 ``w_hh_t``) h rounds to bf16 at the product and the backward
    is the plain bf16 backward (``ops/lstm_bf16.py``)."""
    args = (x, w_ih_t, b_sum, w_hh_t, h0, c0)
    if w_hh_t.dtype == torch.bfloat16:
        operand_dtype("lstm_layer_reference", args)
        ys, hn, cn = _PlainBf16Layer.apply(*args)
        return ys, (hn, cn)
    return lstm_recurrence_reference(x @ w_ih_t + b_sum, w_hh_t, h0, c0)


def lstm_layer_backward_reference(args, dys, dhn, dcn, closure=False):
    """Plain backward: ``torch.autograd.grad`` through the plain forward.
    Returns (dx, dw_ih_t, db_sum, dw_hh_t, dh0, dc0); with
    ``closure=True``, a function that computes them again and again from
    the graph recorded once, so the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        ys, (hn, cn) = lstm_layer_reference(*leaves)

    def grads():
        return torch.autograd.grad((ys, hn, cn), leaves, (dys, dhn, dcn),
                                   retain_graph=closure)
    return grads if closure else grads()


def _lib():
    lib = _build.load("lstm_layer")
    if not getattr(lib, "_typed", False):
        lib.lstm_layer_backward_workspace_floats.argtypes = [_I] * 3
        lib.lstm_layer_backward_workspace_floats.restype = ctypes.c_longlong
        lib.lstm_layer_smem_bytes.argtypes = [_I] * 4
        lib.lstm_layer_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_layer_resident_clusters.argtypes = [_I] * 4
        lib.lstm_layer_resident_clusters.restype = ctypes.c_int
        fns = []
        for mode in ("f32", "bf16"):
            fwd = getattr(lib, f"lstm_layer_forward_{mode}")
            bwd = getattr(lib, f"lstm_layer_backward_{mode}")
            fwd.argtypes = [_P] * 9 + [_I] * 4 + [_P]
            bwd.argtypes = [_P] * 18 + [_I] * 5 + [_P]
            fns += [fwd, bwd]
        lib.lstm_layer_gemm_tc_f32.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        for fn in (*fns, lib.lstm_layer_gemm_tc_f32):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def smem_bytes(hidden: int, backward: bool, rows: int,
               bf16: bool = False) -> int:
    """Shared memory of one CTA of the forward or backward chain at
    ``rows`` batch rows per cluster, of the f32 or the bf16 mode."""
    return _lib().lstm_layer_smem_bytes(hidden, int(backward), rows,
                                        int(bf16))


def resident_clusters(hidden: int, backward: bool, rows: int = 16,
                      bf16: bool = False) -> int:
    """How many 8-CTA clusters of ``rows`` batch rows of the forward or
    backward chain (f32 or bf16 mode) the current card holds at once
    (CUDA only); a larger batch runs in waves."""
    n = _lib().lstm_layer_resident_clusters(hidden, int(backward), rows,
                                            int(bf16))
    if n < 0:
        raise RuntimeError(
            f"lstm_layer: no occupancy at hidden {hidden}, {rows} rows")
    return n


@functools.lru_cache(maxsize=None)
def layout(device_index: int, hidden: int, backward: bool,
           bf16: bool = False):
    """(resident clusters, shared memory) by rows of the forward or
    backward of one mode on one card (``cluster_rows.card_layout``)."""
    with torch.cuda.device(device_index):
        return card_layout(
            lambda r: smem_bytes(hidden, backward, r, bf16),
            lambda r: resident_clusters(hidden, backward, r, bf16))


def _rows(name, device, hidden, backward, batch, rows, bf16=False):
    return resolve_rows(name, batch, rows,
                        layout(device.index or 0, hidden, backward, bf16))


def rows_for(device, hidden: int, backward: bool, batch: int,
             bf16: bool = False) -> int:
    """The rows per cluster the wrapper launches at this batch."""
    return _rows("lstm_layer", device, hidden, backward, batch, None, bf16)


def _check_args(name, args):
    """Raise unless the kernels take these tensors; returns (B, T, din,
    H, bf16 mode)."""
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    bf16 = operand_dtype(name, args) == torch.bfloat16
    b, t, din = x.shape
    h = w_hh_t.shape[0]
    shapes = ((b, t, din), (din, 4 * h), (4 * h,), (h, 4 * h), (b, h),
              (b, h))
    for a, shape in zip(args, shapes):
        if a.device != x.device:
            raise ValueError(
                f"{name} kernel takes tensors on one CUDA device; got "
                f"{a.device} beside {x.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {shape}, got {tuple(a.shape)} "
                f"(contiguous={a.is_contiguous()})"
            )
    if h % 128 or h > _MAX_H:
        raise ValueError(
            f"{name} kernel takes H a multiple of 128 up to {_MAX_H}; got {h}"
        )
    if din % 4:  # dW_ih's product reads x 4 floats at a time
        raise ValueError(
            f"{name} kernel takes din a multiple of 4; got {din}")
    return b, t, din, h, bf16


def lstm_layer_forward(args, residuals: bool, rows: Optional[int] = None):
    """The forward kernel (CUDA only), at ``rows`` batch rows per cluster
    (None: the wrapper's choice). Returns (ys, hn, cn, acts, cs); acts
    (B, T, 4H) and cs (B, T, H) are the backward's residuals, None unless
    ``residuals``."""
    b, t, din, h, bf16 = _check_args("lstm_layer_forward", args)
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    rows = _rows("lstm_layer_forward", x.device, h, False, b, rows, bf16)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=x.device)
    ys, hn, cn = new(b, t, h), new(b, h), new(b, h)
    acts = new(b, t, 4 * h) if residuals else None
    cs = new(b, t, h) if residuals else None
    # bf16 -> f32 is exact: the f32 product of the converted operands is
    # JAX's f32 einsum of the bf16 ones
    xw = torch.addmm(b_sum, x.view(b * t, din).float(), w_ih_t.float())
    lib = _lib()
    fn = lib.lstm_layer_forward_bf16 if bf16 else lib.lstm_layer_forward_f32
    _build.launch(fn, xw, w_hh_t, h0, c0, ys, hn, cn, acts, cs,
                  dims=(b, t, h, rows))
    global fwd_launches, bf16_fwd_launches
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return ys, hn, cn, acts, cs


def lstm_layer_backward(args, ys, acts, cs, dys, dhn, dcn,
                        rows: Optional[int] = None):
    """The backward kernel (CUDA only), from the forward's residuals, at
    ``rows`` batch rows per cluster (None: the wrapper's choice). Returns
    (dx, dw_ih_t, db_sum, dw_hh_t, dh0, dc0), each in its input's
    dtype."""
    b, t, din, h, bf16 = _check_args("lstm_layer_backward", args)
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    rows = _rows("lstm_layer_backward", x.device, h, True, b, rows, bf16)
    cots = [c.float().contiguous() for c in (dys, dhn, dcn)]
    for c, like in zip(cots, (ys, h0, c0)):
        if c.shape != like.shape or c.device != like.device:
            raise ValueError(
                f"lstm_layer_backward: cotangent {tuple(c.shape)} on "
                f"{c.device} for {tuple(like.shape)} on {like.device}")
    grads = [torch.empty_like(a) for a in (x, w_ih_t, b_sum, w_hh_t, h0, c0)]
    lib = _lib()
    ws = torch.empty(lib.lstm_layer_backward_workspace_floats(b, t, h),
                     dtype=torch.float32, device=x.device)
    fn = lib.lstm_layer_backward_bf16 if bf16 else lib.lstm_layer_backward_f32
    _build.launch(fn, x, w_ih_t, w_hh_t, h0, c0, ys, acts, cs, *cots, *grads,
                  ws, dims=(b, t, din, h, rows))
    global bwd_launches, bf16_bwd_launches
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return tuple(grads)


def gemm_tc(a, w, bias=None):
    """a (M, K) @ w (K, N) (+ bias (N,)) in 3xTF32 on the tensor cores:
    the backward's product kernel, to time beside ``torch.addmm`` for the
    forward's input product (CUDA only, f32, contiguous)."""
    (m, k), n = a.shape, w.shape[1]
    if w.shape[0] != k or a.device.type != "cuda":
        raise ValueError(f"gemm_tc: {tuple(a.shape)} @ {tuple(w.shape)} "
                         f"on {a.device}")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    _build.launch(_lib().lstm_layer_gemm_tc_f32, a, w, bias, out,
                  dims=(m, n, k))
    return out


class _LstmLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, cn, acts, cs = lstm_layer_forward(args, residuals=True)
        ctx.save_for_backward(*args, ys, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        *args, ys, acts, cs = ctx.saved_tensors
        return lstm_layer_backward(args, ys, acts, cs, *lstm_bf16.zero_none(
            (dys, dhn, dcn), (ys, args[4], args[5])))


def lstm_layer(
    x: torch.Tensor,       # (B, T, din) f32, or bf16 in the bf16 mode
    w_ih_t: torch.Tensor,  # (din, 4H), x's dtype
    b_sum: torch.Tensor,   # (4H,) f32
    w_hh_t: torch.Tensor,  # (H, 4H), x's dtype
    h0: torch.Tensor, c0: torch.Tensor,  # (B, H) f32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM layer, differentiable; the weights' dtype picks the
    operand mode. CPU tensors take the plain version, CUDA tensors the
    kernels."""
    args = (x, w_ih_t, b_sum, w_hh_t, h0, c0)
    if x.device.type == "cpu":
        return lstm_layer_reference(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn, cn = _LstmLayer.apply(*args)
    else:
        ys, hn, cn, _, _ = lstm_layer_forward(args, residuals=False)
    return ys, (hn, cn)
