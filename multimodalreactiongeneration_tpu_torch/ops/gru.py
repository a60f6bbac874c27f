"""GRU recurrence: CUDA kernels, autograd and plain version.

Counterpart of ``gru_recurrence`` in ``multimodalreactiongeneration_tpu/
ops/pallas_gru.py``, same signature and layouts: ``xw`` (B, T, 3H) =
x @ W_ih^T + b_ih, ``w_hh_t`` (H, 3H) = W_hh^T, ``b_hh`` (3H,), ``h0``
(B, H); gate order r, z, n, with b_hn inside the reset product:
n = tanh(xn + r * (h @ W_hn^T + b_hn)). Returns (ys (B, T, H), h_n (B, H)).

On CPU tensors ``gru_recurrence`` runs ``gru_recurrence_reference``
(autograd records through it). On CUDA tensors it launches
``csrc/gru.cu`` (f32, H 128 or 256, any B; each step's product on the
tensor cores in 3xTF32): where a gradient is needed, the forward that
saves hh = h_{t-1} @ W_hh^T + b_hh of every step (as the JAX
``_vjp_fwd``) and then the backward kernel, which runs the reverse chain
from hh and reduces dW_hh (3xTF32) and db_hh; otherwise the forward
without residuals. A cluster of CTAs runs 16 batch rows; its size per
launch is ``cluster_ctas``. Other shapes and dtypes raise. Launch
counters: ``fwd_launches`` (both forwards) and ``bwd_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build

fwd_launches = 0
bwd_launches = 0

HIDDEN_SIZES = (128, 256)  # the hidden sizes the kernels take
# CTAs per cluster the kernels take at each hidden size, the faster first
# (the sweep in PERF.md)
CLUSTER_CTAS = {256: (16, 8), 128: (8,)}
_P = ctypes.c_void_p
_I = ctypes.c_int
_RESIDENT = {}  # (device index, H, ctas) -> clusters the card holds at once


def gru_recurrence_reference(xw, w_hh_t, b_hh, h0):
    """Plain PyTorch version: only h @ W_hh^T runs inside the time loop
    (the JAX test's ground truth, ``tests/test_pallas_lstm.py
    _gru_scan_ref``)."""
    h = h0
    ys = []
    for t in range(xw.shape[1]):
        hr, hz, hn = (h @ w_hh_t + b_hh).chunk(3, dim=-1)
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def gru_backward_reference(args, dys, dhn, closure=False):
    """Plain backward: ``torch.autograd.grad`` through the plain forward.
    Returns (dxw, dw_hh_t, db_hh, dh0); with ``closure=True``, a function
    that computes them again and again from the graph recorded once, so
    the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        ys, hn = gru_recurrence_reference(*leaves)

    def grads():
        return torch.autograd.grad((ys, hn), leaves, (dys, dhn),
                                   retain_graph=closure)
    return grads if closure else grads()


def kernel_refusal(hidden: int) -> Optional[str]:
    """Why the kernels cannot take a GRU of this hidden size, or None."""
    if hidden not in HIDDEN_SIZES:
        return (f"hidden size {hidden}: the kernels take {HIDDEN_SIZES} (a "
                "CTA of the 8-CTA cluster owns H/8 units, 16 or 32)")
    return None


def cluster_ctas(b: int, h: int, resident) -> int:
    """CTAs per cluster for a batch of b rows at hidden size h: the first
    size of ``CLUSTER_CTAS[h]`` at which the card holds all ceil(b / 16)
    clusters at once (``resident(ctas)``: how many it holds), else the
    last (whose clusters then run in waves)."""
    *faster, last = CLUSTER_CTAS[h]
    for ctas in faster:
        if -(-b // 16) <= resident(ctas):
            return ctas
    return last


def _lib():
    lib = _build.load("gru")
    if not getattr(lib, "_typed", False):
        lib.gru_backward_workspace_floats.argtypes = [_I] * 3
        lib.gru_backward_workspace_floats.restype = ctypes.c_longlong
        lib.gru_resident_clusters.argtypes = [_I] * 2
        lib.gru_resident_clusters.restype = ctypes.c_int
        lib.gru_forward_f32.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.gru_backward_f32.argtypes = [_P] * 12 + [_I] * 4 + [_P]
        lib.gru_forward_f32.restype = ctypes.c_int
        lib.gru_backward_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_ctas(device, b: int, h: int) -> int:
    """``cluster_ctas`` on this CUDA device (its occupancy query, once)."""
    def resident(ctas):
        key = (device.index, h, ctas)
        if key not in _RESIDENT:
            with torch.cuda.device(device):
                _RESIDENT[key] = _lib().gru_resident_clusters(h, ctas)
        return _RESIDENT[key]
    return cluster_ctas(b, h, resident)


def _check(name, xw, w_hh_t, b_hh, h0, **more):
    """Raise unless the kernels take these tensors: f32, contiguous, on
    one CUDA device, shapes from xw (B, T, 3H); ``more`` maps each further
    tensor to its expected shape as a function of (B, T, H). Returns
    (B, T, H)."""
    if xw.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {xw.device}")
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"{name}: xw must be (B, T, 3H), got "
                         f"{tuple(xw.shape)}")
    b, t, g3 = xw.shape
    h = g3 // 3
    want = dict(xw=(xw, (b, t, g3)), w_hh_t=(w_hh_t, (h, g3)),
                b_hh=(b_hh, (g3,)), h0=(h0, (b, h)))
    want.update({k: (v, tuple(s(b, t, h))) for k, (v, s) in more.items()})
    for key, (a, shape) in want.items():
        if a.device != xw.device or a.dtype != torch.float32:
            raise ValueError(
                f"{name} kernel takes f32 tensors on one CUDA device; got "
                f"{key} {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: expected {key} contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})")
    why = kernel_refusal(h) if b >= 1 and t >= 1 else f"B {b}, T {t}"
    if why is not None:
        raise ValueError(f"{name}: no kernel for {why}")
    return b, t, h


def gru_forward(args, residuals: bool):
    """The forward kernel (CUDA only). Returns (ys, hn, hh); hh (B, T, 3H)
    is the backward's residual, None unless ``residuals``."""
    b, t, h = _check("gru_forward", *args)
    xw = args[0]
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=xw.device)
    ys, hn = new(b, t, h), new(b, h)
    hh = new(b, t, 3 * h) if residuals else None
    _build.launch(_lib().gru_forward_f32, *args, ys, hn, hh,
                  dims=(b, t, h, launch_ctas(xw.device, b, h)))
    global fwd_launches
    fwd_launches += 1
    return ys, hn, hh


def gru_backward(args, ys, hh, dys, dhn):
    """The backward kernel (CUDA only), from the forward's ys and hh.
    Returns (dxw, dw_hh_t, db_hh, dh0)."""
    xw, w_hh_t, b_hh, h0 = args
    # the dW_hh reduction reads ys and h0 16 bytes at a time
    ys, h0 = [a.clone() if a.data_ptr() % 16 else a for a in (ys, h0)]
    cots = [c.float().contiguous() for c in (dys, dhn)]
    b, t, h = _check("gru_backward", *args,
                     ys=(ys, lambda b, t, h: (b, t, h)),
                     hh=(hh, lambda b, t, h: (b, t, 3 * h)),
                     dys=(cots[0], lambda b, t, h: (b, t, h)),
                     dhn=(cots[1], lambda b, t, h: (b, h)))
    grads = [torch.empty_like(a) for a in args]
    lib = _lib()
    ws = torch.empty(lib.gru_backward_workspace_floats(b, t, h),
                     dtype=torch.float32, device=xw.device)
    _build.launch(lib.gru_backward_f32, xw, hh, w_hh_t, h0, ys, *cots,
                  grads[0], grads[1], grads[2], grads[3], ws,
                  dims=(b, t, h, launch_ctas(xw.device, b, h)))
    global bwd_launches
    bwd_launches += 1
    return tuple(grads)


class _Gru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, hh = gru_forward(args, residuals=True)
        ctx.save_for_backward(*args, ys, hh)
        return ys, hn

    @staticmethod
    def backward(ctx, dys, dhn):
        *args, ys, hh = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys
        dhn = torch.zeros_like(args[3]) if dhn is None else dhn
        return gru_backward(args, ys, hh, dys, dhn)


def gru_recurrence(
    xw: torch.Tensor,      # (B, T, 3H) f32
    w_hh_t: torch.Tensor,  # (H, 3H)
    b_hh: torch.Tensor,    # (3H,)
    h0: torch.Tensor,      # (B, H)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU recurrence, differentiable. CPU tensors take the plain
    version, CUDA tensors the kernels."""
    args = (xw, w_hh_t, b_hh, h0)
    if xw.device.type == "cpu":
        return gru_recurrence_reference(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _Gru.apply(*args)
    ys, hn, _ = gru_forward(args, residuals=False)
    return ys, hn
