"""One LSTM layer (input projection + recurrence): CUDA kernels, autograd
and plain version.

Counterpart of ``lstm_layer`` in ``multimodalreactiongeneration_tpu/ops/
pallas_lstm.py``, same signature and layouts: ``x`` (B, T, din),
``w_ih_t`` (din, 4H) = W_ih^T, ``b_sum`` (4H,) = b_ih + b_hh, ``w_hh_t``
(H, 4H) = W_hh^T, ``h0``/``c0`` (B, H); gate order i, f, g, o. Returns
(ys (B, T, H), (h_n, c_n)).

On CPU tensors ``lstm_layer`` runs ``lstm_layer_reference`` (autograd
records through it). On CUDA tensors it computes xw = x W_ih^T + b with
one FP32 ``torch.addmm`` (as JAX leaves it to XLA) and launches
``csrc/lstm_layer.cu`` (f32, H 128 or 256, din a multiple of 4): where
a gradient is needed, the forward that stores the backward's residuals
and then the backward kernel; otherwise the forward without residuals. Each chain runs R batch
rows per cluster, the smallest R the card holds in one wave
(``cluster_rows.choose_rows``), or the ``rows`` a caller names. Launch
counters: ``fwd_launches`` (both forwards) and ``bwd_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops.cluster_rows import (
    card_layout,
    resolve_rows,
)
from multimodalreactiongeneration_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence_reference,
)

fwd_launches = 0
bwd_launches = 0

_MAX_H = 256
_P = ctypes.c_void_p
_I = ctypes.c_int


def lstm_layer_reference(x, w_ih_t, b_sum, w_hh_t, h0, c0):
    """Plain PyTorch version: the projection for the whole sequence is one
    matmul, only h @ W_hh^T runs inside the time loop."""
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
        lib.lstm_layer_smem_bytes.argtypes = [_I] * 3
        lib.lstm_layer_smem_bytes.restype = ctypes.c_longlong
        lib.lstm_layer_resident_clusters.argtypes = [_I] * 3
        lib.lstm_layer_resident_clusters.restype = ctypes.c_int
        lib.lstm_layer_forward_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.lstm_layer_backward_f32.argtypes = [_P] * 18 + [_I] * 5 + [_P]
        lib.lstm_layer_gemm_tc_f32.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        for fn in (lib.lstm_layer_forward_f32, lib.lstm_layer_backward_f32,
                   lib.lstm_layer_gemm_tc_f32):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def smem_bytes(hidden: int, backward: bool, rows: int) -> int:
    """Shared memory of one CTA of the forward or backward chain at
    ``rows`` batch rows per cluster."""
    return _lib().lstm_layer_smem_bytes(hidden, int(backward), rows)


def resident_clusters(hidden: int, backward: bool, rows: int = 16) -> int:
    """How many 8-CTA clusters of ``rows`` batch rows of the forward or
    backward chain the current card holds at once (CUDA only); a larger
    batch runs in waves."""
    n = _lib().lstm_layer_resident_clusters(hidden, int(backward), rows)
    if n < 0:
        raise RuntimeError(
            f"lstm_layer: no occupancy at hidden {hidden}, {rows} rows")
    return n


@functools.lru_cache(maxsize=None)
def layout(device_index: int, hidden: int, backward: bool):
    """(resident clusters, shared memory) by rows of the forward or
    backward on one card (``cluster_rows.card_layout``)."""
    with torch.cuda.device(device_index):
        return card_layout(lambda r: smem_bytes(hidden, backward, r),
                           lambda r: resident_clusters(hidden, backward, r))


def _rows(name, device, hidden, backward, batch, rows):
    return resolve_rows(name, batch, rows,
                        layout(device.index or 0, hidden, backward))


def rows_for(device, hidden: int, backward: bool, batch: int) -> int:
    """The rows per cluster the wrapper launches at this batch."""
    return _rows("lstm_layer", device, hidden, backward, batch, None)


def _check_args(name, args):
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    b, t, din = x.shape
    h = w_hh_t.shape[0]
    shapes = ((b, t, din), (din, 4 * h), (4 * h,), (h, 4 * h), (b, h),
              (b, h))
    for a, shape in zip(args, shapes):
        if a.device != x.device or a.dtype != torch.float32:
            raise ValueError(
                f"{name} kernel takes f32 tensors on one CUDA device; got "
                f"{a.dtype} on {a.device}"
            )
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
    return b, t, din, h


def lstm_layer_forward(args, residuals: bool, rows: Optional[int] = None):
    """The forward kernel (CUDA only), at ``rows`` batch rows per cluster
    (None: the wrapper's choice). Returns (ys, hn, cn, acts, cs); acts
    (B, T, 4H) and cs (B, T, H) are the backward's residuals, None unless
    ``residuals``."""
    b, t, din, h = _check_args("lstm_layer_forward", args)
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    rows = _rows("lstm_layer_forward", x.device, h, False, b, rows)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=x.device)
    ys, hn, cn = new(b, t, h), new(b, h), new(b, h)
    acts = new(b, t, 4 * h) if residuals else None
    cs = new(b, t, h) if residuals else None
    xw = torch.addmm(b_sum, x.view(b * t, din), w_ih_t)
    _build.launch(_lib().lstm_layer_forward_f32, xw, w_hh_t, h0, c0, ys, hn,
                  cn, acts, cs, dims=(b, t, h, rows))
    global fwd_launches
    fwd_launches += 1
    return ys, hn, cn, acts, cs


def lstm_layer_backward(args, ys, acts, cs, dys, dhn, dcn,
                        rows: Optional[int] = None):
    """The backward kernel (CUDA only), from the forward's residuals, at
    ``rows`` batch rows per cluster (None: the wrapper's choice). Returns
    (dx, dw_ih_t, db_sum, dw_hh_t, dh0, dc0)."""
    b, t, din, h = _check_args("lstm_layer_backward", args)
    x, w_ih_t, b_sum, w_hh_t, h0, c0 = args
    rows = _rows("lstm_layer_backward", x.device, h, True, b, rows)
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
    _build.launch(lib.lstm_layer_backward_f32, x, w_ih_t, w_hh_t, h0, c0, ys,
                  acts, cs, *cots, *grads, ws, dims=(b, t, din, h, rows))
    global bwd_launches
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
        dys, dhn, dcn = (
            torch.zeros_like(like) if c is None else c
            for c, like in zip((dys, dhn, dcn), (ys, args[4], args[5]))
        )
        return lstm_layer_backward(args, ys, acts, cs, dys, dhn, dcn)


def lstm_layer(
    x: torch.Tensor,       # (B, T, din) f32
    w_ih_t: torch.Tensor,  # (din, 4H)
    b_sum: torch.Tensor,   # (4H,)
    w_hh_t: torch.Tensor,  # (H, 4H)
    h0: torch.Tensor, c0: torch.Tensor,  # (B, H)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM layer, differentiable. CPU tensors take the plain
    version, CUDA tensors the kernels."""
    args = (x, w_ih_t, b_sum, w_hh_t, h0, c0)
    if x.device.type == "cpu":
        return lstm_layer_reference(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn, cn = _LstmLayer.apply(*args)
    else:
        ys, hn, cn, _, _ = lstm_layer_forward(args, residuals=False)
    return ys, (hn, cn)
