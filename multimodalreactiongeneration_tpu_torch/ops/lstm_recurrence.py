"""LSTM recurrence over precomputed input projections: CUDA kernels,
autograd and plain version.

Counterpart of ``lstm_recurrence`` in ``multimodalreactiongeneration_tpu/
ops/pallas_lstm.py`` (K8), same signature and layouts: ``xw`` (B, T, 4H)
= x @ W_ih^T + b_ih + b_hh, ``w_hh_t`` (H, 4H) = W_hh^T, ``h0``/``c0``
(B, H); gate order i, f, g, o. Returns (ys (B, T, H), (h_n, c_n)); its
gradients are (dxw, dW_hh^T, dh0, dc0).

On CPU tensors ``lstm_recurrence`` runs ``lstm_recurrence_reference``
(autograd records through it). On CUDA tensors it launches
``csrc/lstm_recurrence.cu`` (f32, H 128 or 256, any B and T; each step's
product on the tensor cores in 3xTF32): where a gradient is needed, the
forward that saves the gate activations and cell states, then the
backward kernel (the reverse chain writes dxw, then a deterministic
3xTF32 split-K reduction gives dW_hh^T); otherwise the forward without
residuals. A cluster of CTAs runs 16 batch rows; its size per launch is
``launch_ctas`` (``ops/cluster_size.py``). Other shapes and dtypes
raise, naming K8. Launch counters: ``fwd_launches`` (both forwards) and
``bwd_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops import cluster_size

fwd_launches = 0
bwd_launches = 0

HIDDEN_SIZES = (128, 256)  # the hidden sizes the kernels take
# CTAs per cluster the kernels take at each hidden size, the faster first
# (the sweep in PERF.md)
CLUSTER_CTAS = {256: (16, 8), 128: (8, 4)}
_P = ctypes.c_void_p
_I = ctypes.c_int


def lstm_recurrence_reference(xw, w_hh_t, h0, c0):
    """Plain PyTorch version: only h @ W_hh^T runs inside the time loop."""
    h, c = h0, c0
    ys = []
    for t in range(xw.shape[1]):
        gates = xw[:, t] + h @ w_hh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def lstm_recurrence_backward_reference(args, dys, dhn, dcn, closure=False):
    """Plain backward: ``torch.autograd.grad`` through the plain forward.
    Returns (dxw, dw_hh_t, dh0, dc0); with ``closure=True``, a function
    that computes them again and again from the graph recorded once, so
    the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        ys, (hn, cn) = lstm_recurrence_reference(*leaves)

    def grads():
        return torch.autograd.grad((ys, hn, cn), leaves, (dys, dhn, dcn),
                                   retain_graph=closure)
    return grads if closure else grads()


def kernel_refusal(hidden: int) -> Optional[str]:
    """Why the kernels cannot take an LSTM of this hidden size, or None."""
    if hidden not in HIDDEN_SIZES:
        return (f"hidden size {hidden}: the K8 kernels take {HIDDEN_SIZES} "
                "(a CTA of a cluster of 8 or 16 owns the i, f, g, o gate "
                "columns of 16 or 32 units, whole tensor-core tiles of 8)")
    return None


def _lib():
    lib = _build.load("lstm_recurrence")
    if not getattr(lib, "_typed", False):
        lib.lstm_recurrence_backward_workspace_floats.argtypes = [_I] * 3
        lib.lstm_recurrence_backward_workspace_floats.restype = (
            ctypes.c_longlong)
        lib.lstm_recurrence_resident_clusters.argtypes = [_I] * 2
        lib.lstm_recurrence_resident_clusters.restype = ctypes.c_int
        lib.lstm_recurrence_forward_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.lstm_recurrence_backward_f32.argtypes = [_P] * 14 + [_I] * 4 + [_P]
        lib.lstm_recurrence_forward_f32.restype = ctypes.c_int
        lib.lstm_recurrence_backward_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_ctas(device, b: int, h: int) -> int:
    """CTAs per cluster of a launch on this CUDA device: the first size of
    ``CLUSTER_CTAS[h]`` at which the card holds the batch's clusters at
    once (``cluster_size.launch_ctas``)."""
    return cluster_size.launch_ctas(
        f"lstm_recurrence H{h}", device, b, CLUSTER_CTAS[h],
        lambda ctas: _lib().lstm_recurrence_resident_clusters(h, ctas))


def _check(name, xw, w_hh_t, h0, c0, **more):
    """Raise unless the kernels take these tensors: f32, contiguous, on
    one CUDA device, shapes from xw (B, T, 4H); ``more`` maps each further
    tensor to its expected shape as a function of (B, T, H). Returns
    (B, T, H)."""
    if xw.device.type != "cuda":
        raise ValueError(f"{name}: no K8 kernel for {xw.device}")
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"{name}: K8 takes xw (B, T, 4H), got "
                         f"{tuple(xw.shape)}")
    b, t, g4 = xw.shape
    h = g4 // 4
    want = dict(xw=(xw, (b, t, g4)), w_hh_t=(w_hh_t, (h, g4)),
                h0=(h0, (b, h)), c0=(c0, (b, h)))
    want.update({k: (v, tuple(s(b, t, h))) for k, (v, s) in more.items()})
    for key, (a, shape) in want.items():
        if a.device != xw.device or a.dtype != torch.float32:
            raise ValueError(
                f"{name}: the K8 kernels take f32 tensors on one CUDA "
                f"device; got {key} {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: K8 expects {key} contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})")
    why = kernel_refusal(h) if b >= 1 and t >= 1 else f"B {b}, T {t}"
    if why is not None:
        raise ValueError(f"{name}: no K8 kernel for {why}")
    return b, t, h


def lstm_recurrence_forward(args, residuals: bool):
    """The forward kernel (CUDA only). Returns (ys, hn, cn, acts, cs);
    acts (B, T, 4H) and cs (B, T, H) are the backward's residuals, None
    unless ``residuals``."""
    b, t, h = _check("lstm_recurrence_forward", *args)
    ctas = launch_ctas(args[0].device, b, h)
    xw = args[0]
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=xw.device)
    ys, hn, cn = new(b, t, h), new(b, h), new(b, h)
    acts = new(b, t, 4 * h) if residuals else None
    cs = new(b, t, h) if residuals else None
    _build.launch(_lib().lstm_recurrence_forward_f32, *args, ys, hn, cn,
                  acts, cs, dims=(b, t, h, ctas))
    global fwd_launches
    fwd_launches += 1
    return ys, hn, cn, acts, cs


def lstm_recurrence_backward(args, ys, acts, cs, dys, dhn, dcn):
    """The backward kernel (CUDA only), from the forward's residuals.
    Returns (dxw, dw_hh_t, dh0, dc0)."""
    xw, w_hh_t, h0, c0 = args
    # the dW_hh reduction reads ys and h0 16 bytes at a time
    ys, h0 = [a.clone() if a.data_ptr() % 16 else a for a in (ys, h0)]
    cots = [c.float().contiguous() for c in (dys, dhn, dcn)]
    b, t, h = _check("lstm_recurrence_backward", *args,
                     ys=(ys, lambda b, t, h: (b, t, h)),
                     acts=(acts, lambda b, t, h: (b, t, 4 * h)),
                     cs=(cs, lambda b, t, h: (b, t, h)),
                     dys=(cots[0], lambda b, t, h: (b, t, h)),
                     dhn=(cots[1], lambda b, t, h: (b, h)),
                     dcn=(cots[2], lambda b, t, h: (b, h)))
    ctas = launch_ctas(xw.device, b, h)
    grads = [torch.empty_like(a) for a in args]
    lib = _lib()
    ws = torch.empty(lib.lstm_recurrence_backward_workspace_floats(b, t, h),
                     dtype=torch.float32, device=xw.device)
    _build.launch(lib.lstm_recurrence_backward_f32, w_hh_t, h0, c0, ys, acts,
                  cs, *cots, *grads, ws, dims=(b, t, h, ctas))
    global bwd_launches
    bwd_launches += 1
    return tuple(grads)


class _LstmRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, cn, acts, cs = lstm_recurrence_forward(args, residuals=True)
        ctx.save_for_backward(*args, ys, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        *args, ys, acts, cs = ctx.saved_tensors
        dys, dhn, dcn = (
            torch.zeros_like(like) if c is None else c
            for c, like in zip((dys, dhn, dcn), (ys, args[2], args[3]))
        )
        return lstm_recurrence_backward(args, ys, acts, cs, dys, dhn, dcn)


def lstm_recurrence(
    xw: torch.Tensor,      # (B, T, 4H) f32
    w_hh_t: torch.Tensor,  # (H, 4H)
    h0: torch.Tensor, c0: torch.Tensor,  # (B, H)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The LSTM recurrence, differentiable. CPU tensors take the plain
    version, CUDA tensors the kernels."""
    args = (xw, w_hh_t, h0, c0)
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn, cn = _LstmRecurrence.apply(*args)
    else:
        ys, hn, cn, _, _ = lstm_recurrence_forward(args, residuals=False)
    return ys, (hn, cn)
