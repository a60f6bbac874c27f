"""GRU recurrence: CUDA kernels, autograd and plain version.

Counterpart of ``gru_recurrence`` in ``multimodalreactiongeneration_tpu/
ops/pallas_gru.py``, same signature and layouts: ``xw`` (B, T, 3H) =
x @ W_ih^T + b_ih, ``w_hh_t`` (H, 3H) = W_hh^T, ``b_hh`` (3H,), ``h0``
(B, H); gate order r, z, n, with b_hn inside the reset product:
n = tanh(xn + r * (h @ W_hn^T + b_hn)). Returns (ys (B, T, H), h_n (B, H)).

Two operand modes, as JAX's ``gru_recurrence`` takes them: every tensor
f32, or the bf16 mode, where bf16 ``w_hh_t`` makes the kernel round h
(forward) and dhh (the backward's carry product) to bf16 at the product
with W_hh, summing in f32; xw, b_hh and h0 stay f32, and so do the
state, the gate math, b_hh's add and the outputs. In the bf16 mode dW_hh
is bf16(h_{t-1})^T bf16(dhh) summed in f32 over all rows and rounded to
bf16 (the weights' dtype), db_hh the f32 sum of dhh, dxw and dh0 f32.
Any other mix of dtypes raises.

On CPU tensors ``gru_recurrence`` runs ``gru_recurrence_reference``
(f32: autograd records through it; bf16: the plain bf16 version, its
backward written out step by step, as ``ops/lstm_bf16.py`` does for the
LSTM chains, since autograd through the roundings would round the
cotangents too). On CUDA tensors it launches ``csrc/gru.cu`` (built for
H 64, 128, 192 and 256, any B; each step's product on the tensor cores,
in 3xTF32 or, in the bf16 mode, bf16 ``mma.sync``); any other H up to
256 runs on the next of those sizes, its gate blocks, W_hh's rows, b_hh
and h0 padded with zero units and the outputs' padded units dropped
(``ops/hidden_pad.py``: exact; the padding is part of
``gru_recurrence`` and the launches are the same). Where a gradient is
needed, the
forward that saves hh = h_{t-1} @ W_hh^T + b_hh of every step (as the JAX
``_vjp_fwd``) and then the backward kernel, which runs the reverse chain
from hh and reduces dW_hh and db_hh; otherwise the forward without
residuals. A cluster of CTAs runs 16 batch rows; its size per launch is
``launch_ctas`` (``ops/cluster_size.py``), from the occupancy of the
mode's own instantiation. H above 256 raises, naming K10. Launch
counters:
``fwd_launches`` (both f32 forwards), ``bwd_launches``,
``bf16_fwd_launches`` and ``bf16_bwd_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops import cluster_size, lstm_bf16
from multimodalreactiongeneration_tpu_torch.ops.hidden_pad import (
    HIDDEN_SIZES,
    pad_gates,
    pad_units,
    pad_weight,
    padded_hidden,
    unbuilt,
    unpad_units,
)

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0

# CTAs per cluster the kernels take at each hidden size they are built
# for (``HIDDEN_SIZES``), the faster first (the sweep in PERF.md; at H 64
# and 192, 16 and 32 units a CTA as at H 256)
CLUSTER_CTAS = {256: (16, 8), 192: (12, 6), 128: (8,), 64: (4, 2)}
_P = ctypes.c_void_p
_I = ctypes.c_int


_OPERANDS = ("xw", "w_hh_t", "b_hh", "h0")


def operand_dtype(name, args) -> torch.dtype:
    """The operand mode of (xw, w_hh_t, b_hh, h0): f32 or bf16
    (``lstm_bf16.recurrence_operand_dtype``)."""
    return lstm_bf16.recurrence_operand_dtype(f"{name} (K10)", args,
                                              _OPERANDS)


def gru_bf16_forward(xw, w_hh_t, b_hh, h0):
    """The plain bf16 mode: (ys, hn, hh), all f32; hh (B, T, 3H) = bf16(h)
    W_hh + b_hh of every step, the backward's residual."""
    w = w_hh_t.float()
    h = h0
    ys, hhs = [], []
    for t in range(xw.shape[1]):
        hh = lstm_bf16.round_bf16(h) @ w + b_hh
        hr, hz, hn = hh.chunk(3, dim=-1)
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
        hhs.append(hh)
    return torch.stack(ys, dim=1), h, torch.stack(hhs, dim=1)


def gru_bf16_backward(xw, w_hh_t, h0, ys, hh, dys, dhn):
    """The plain bf16 mode's gradients (dxw, dw_hh_t, db_hh, dh0) from the
    forward's ys and hh and the f32 cotangents: the reverse chain carries
    dh z + bf16(dhh) W_hh^T; dW_hh = bf16(h_{t-1})^T bf16(dhh), f32 sums,
    rounded to bf16 (``lstm_bf16.tn``); db_hh the f32 sum of dhh."""
    w_t = w_hh_t.float().T  # (3H, H)
    prev = lstm_bf16.shifted(ys, h0)
    carry = dhn
    dxw, dhh = [None] * xw.shape[1], [None] * xw.shape[1]
    for t in reversed(range(xw.shape[1])):
        hr, hz, hn = hh[:, t].chunk(3, dim=-1)
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dys[:, t] + carry
        dgn = dh * (1.0 - z) * (1.0 - n * n)
        dgr = dgn * hn * r * (1.0 - r)
        dgz = dh * (prev[:, t] - n) * z * (1.0 - z)
        dxw[t] = torch.cat([dgr, dgz, dgn], dim=-1)
        dhh[t] = torch.cat([dgr, dgz, dgn * r], dim=-1)
        carry = dh * z + lstm_bf16.round_bf16(dhh[t]) @ w_t
    dhh = torch.stack(dhh, dim=1)
    return (torch.stack(dxw, dim=1), lstm_bf16.tn(prev, dhh),
            dhh.sum((0, 1)), carry)


class _PlainBf16Gru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xw, w_hh_t, b_hh, h0):
        ys, hn, hh = gru_bf16_forward(xw, w_hh_t, b_hh, h0)
        ctx.save_for_backward(xw, w_hh_t, h0, ys, hh)
        return ys, hn

    @staticmethod
    def backward(ctx, dys, dhn):
        xw, w_hh_t, h0, ys, hh = ctx.saved_tensors
        dys, dhn = lstm_bf16.zero_none((dys, dhn), (ys, h0))
        return gru_bf16_backward(xw, w_hh_t, h0, ys, hh, dys.float(),
                                 dhn.float())


def gru_recurrence_reference(xw, w_hh_t, b_hh, h0):
    """Plain PyTorch version: only h @ W_hh^T runs inside the time loop
    (the JAX test's ground truth, ``tests/test_pallas_lstm.py
    _gru_scan_ref``). In the bf16 mode (bf16 ``w_hh_t``) h rounds to bf16
    at the product and the backward is the plain bf16 backward."""
    if w_hh_t.dtype == torch.bfloat16:
        operand_dtype("gru_recurrence_reference", (xw, w_hh_t, b_hh, h0))
        return _PlainBf16Gru.apply(xw, w_hh_t, b_hh, h0)
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
    """Why ``gru_recurrence`` cannot take a GRU of this hidden size on
    CUDA, or None: every H from 1 to 256 runs (on ``padded_hidden(H)``)."""
    if padded_hidden(hidden) is None:
        return (f"hidden size {hidden}: the K10 kernels take hidden sizes 1 "
                f"to {HIDDEN_SIZES[-1]} (built for {HIDDEN_SIZES}, the "
                "others padded with zero units to the next; a CTA of the "
                "cluster owns the r, z, n gate columns of 16 or 32 units "
                "and W_hh stays in the cluster's registers)")
    return None


def pad_args(args, hp: int):
    """(xw, w_hh_t, b_hh, h0) of hidden size H as hidden size ``hp`` >= H:
    each gate block of xw, of W_hh's columns and of b_hh, W_hh's rows and
    h0 padded with zero units (``ops/hidden_pad.py``; differentiable)."""
    xw, w_hh_t, b_hh, h0 = args
    return (pad_gates(xw, 3, hp), pad_weight(w_hh_t, 3, hp),
            pad_gates(b_hh, 3, hp), pad_units(h0, hp))


def unpad_outputs(ys, hn, h: int):
    """(ys, h_n) of a padded run cut to the first ``h`` units."""
    return unpad_units(ys, h), unpad_units(hn, h)


def _lib():
    lib = _build.load("gru")
    if not getattr(lib, "_typed", False):
        lib.gru_backward_workspace_floats.argtypes = [_I] * 3
        lib.gru_backward_workspace_floats.restype = ctypes.c_longlong
        for mode in ("f32", "bf16"):
            query = getattr(lib, "gru_resident_clusters"
                            + ("_bf16" if mode == "bf16" else ""))
            query.argtypes = [_I] * 2
            query.restype = ctypes.c_int
            fwd = getattr(lib, f"gru_forward_{mode}")
            bwd = getattr(lib, f"gru_backward_{mode}")
            fwd.argtypes = [_P] * 7 + [_I] * 4 + [_P]
            bwd.argtypes = [_P] * 12 + [_I] * 4 + [_P]
            fwd.restype = bwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_ctas(device, b: int, h: int, bf16: bool = False) -> int:
    """CTAs per cluster of a launch of the f32 or the bf16 mode on this
    CUDA device: the first size of ``CLUSTER_CTAS[h]`` at which the card
    holds the batch's clusters of that mode's kernels at once
    (``cluster_size.launch_ctas``)."""
    return cluster_size.launch_ctas(
        f"gru H{h}" + (" bf16" if bf16 else ""), device, b, CLUSTER_CTAS[h],
        lambda ctas: (_lib().gru_resident_clusters_bf16 if bf16
                      else _lib().gru_resident_clusters)(h, ctas))


def _check(name, xw, w_hh_t, b_hh, h0, **more):
    """Raise unless the kernels take these tensors: one operand mode
    (``operand_dtype``; the further tensors f32), contiguous, on one CUDA
    device, shapes from xw (B, T, 3H); ``more`` maps each further tensor
    to its expected shape as a function of (B, T, H). Returns (B, T, H,
    bf16 mode)."""
    if xw.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {xw.device}")
    bf16 = operand_dtype(name, (xw, w_hh_t, b_hh, h0)) == torch.bfloat16
    if xw.dim() != 3 or xw.shape[2] % 3:
        raise ValueError(f"{name}: xw must be (B, T, 3H), got "
                         f"{tuple(xw.shape)}")
    b, t, g3 = xw.shape
    h = g3 // 3
    want = dict(xw=(xw, (b, t, g3)), w_hh_t=(w_hh_t, (h, g3)),
                b_hh=(b_hh, (g3,)), h0=(h0, (b, h)))
    want.update({k: (v, tuple(s(b, t, h))) for k, (v, s) in more.items()})
    for key, (a, shape) in want.items():
        if a.device != xw.device or (key != "w_hh_t"
                                     and a.dtype != torch.float32):
            raise ValueError(
                f"{name} kernel takes tensors on one CUDA device, f32 but "
                f"w_hh_t; got {key} {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: expected {key} contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})")
    why = f"B {b}, T {t}"
    if b >= 1 and t >= 1:
        why = kernel_refusal(h) or unbuilt(h, "K10", "gru_recurrence")
    if why is not None:
        raise ValueError(f"{name}: no kernel for {why}")
    return b, t, h, bf16


def gru_forward(args, residuals: bool):
    """The forward kernel (CUDA only), in the operand mode of ``args``.
    Returns (ys, hn, hh); hh (B, T, 3H) is the backward's residual, None
    unless ``residuals``."""
    b, t, h, bf16 = _check("gru_forward", *args)
    xw = args[0]
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=xw.device)
    ys, hn = new(b, t, h), new(b, h)
    hh = new(b, t, 3 * h) if residuals else None
    lib = _lib()
    _build.launch(lib.gru_forward_bf16 if bf16 else lib.gru_forward_f32,
                  *args, ys, hn, hh,
                  dims=(b, t, h, launch_ctas(xw.device, b, h, bf16)))
    global fwd_launches, bf16_fwd_launches
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return ys, hn, hh


def gru_backward(args, ys, hh, dys, dhn):
    """The backward kernel (CUDA only), from the forward's ys and hh.
    Returns (dxw, dw_hh_t, db_hh, dh0), each in its input's dtype."""
    xw, w_hh_t, b_hh, h0 = args
    # the dW_hh reduction reads ys and h0 16 bytes at a time
    ys, h0 = [a.clone() if a.data_ptr() % 16 else a for a in (ys, h0)]
    cots = [c.float().contiguous() for c in (dys, dhn)]
    b, t, h, bf16 = _check("gru_backward", *args,
                     ys=(ys, lambda b, t, h: (b, t, h)),
                     hh=(hh, lambda b, t, h: (b, t, 3 * h)),
                     dys=(cots[0], lambda b, t, h: (b, t, h)),
                     dhn=(cots[1], lambda b, t, h: (b, h)))
    grads = [torch.empty_like(a) for a in args]
    lib = _lib()
    ws = torch.empty(lib.gru_backward_workspace_floats(b, t, h),
                     dtype=torch.float32, device=xw.device)
    _build.launch(lib.gru_backward_bf16 if bf16 else lib.gru_backward_f32,
                  xw, hh, w_hh_t, h0, ys, *cots, *grads, ws,
                  dims=(b, t, h, launch_ctas(xw.device, b, h, bf16)))
    global bwd_launches, bf16_bwd_launches
    if bf16:
        bf16_bwd_launches += 1
    else:
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
        return gru_backward(args, ys, hh, *lstm_bf16.zero_none(
            (dys, dhn), (ys, args[3])))


def gru_recurrence(
    xw: torch.Tensor,      # (B, T, 3H) f32
    w_hh_t: torch.Tensor,  # (H, 3H) f32, or bf16 in the bf16 mode
    b_hh: torch.Tensor,    # (3H,) f32
    h0: torch.Tensor,      # (B, H) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU recurrence, differentiable; ``w_hh_t``'s dtype picks the
    operand mode. CPU tensors take the plain version, CUDA tensors the
    kernels: a hidden size they are not built for on its arguments padded
    to ``padded_hidden`` (``pad_args``), the outputs cut back
    (``unpad_outputs``); above 256 it raises, naming K10."""
    args = (xw, w_hh_t, b_hh, h0)
    if xw.device.type == "cpu":
        return gru_recurrence_reference(*args)
    h = h0.shape[-1]
    hp = padded_hidden(h) or h
    if hp != h and xw.shape[-1] == 3 * h:
        args = pad_args(args, hp)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn = _Gru.apply(*args)
    else:
        ys, hn, _ = gru_forward(args, residuals=False)
    return unpad_outputs(ys, hn, h)
