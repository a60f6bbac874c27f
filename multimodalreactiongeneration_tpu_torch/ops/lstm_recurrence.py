"""LSTM recurrence over precomputed input projections: CUDA kernels,
autograd and plain version.

Counterpart of ``lstm_recurrence`` in ``multimodalreactiongeneration_tpu/
ops/pallas_lstm.py`` (K8), same signature and layouts: ``xw`` (B, T, 4H)
= x @ W_ih^T + b_ih + b_hh, ``w_hh_t`` (H, 4H) = W_hh^T, ``h0``/``c0``
(B, H); gate order i, f, g, o. Returns (ys (B, T, H), (h_n, c_n)); its
gradients are (dxw, dW_hh^T, dh0, dc0).

Two operand modes, as JAX's ``lstm_recurrence`` takes them: every tensor
f32, or the bf16 mode, where bf16 ``w_hh_t`` makes the kernel round h
(forward) and the dgates (the backward's carry product) to bf16 at the
product with W_hh, summing in f32 (``ops/lstm_bf16.py``); xw, h0 and c0
stay f32, and so do the state, the cell math and the outputs. In the
bf16 mode dW_hh is bf16(h_{t-1})^T bf16(dgates) summed in f32 over all
rows and rounded to bf16 (the weights' dtype: JAX's einsum at
``_bwd_impl``), dxw, dh0 and dc0 f32. Any other mix of dtypes raises.

On CPU tensors ``lstm_recurrence`` runs ``lstm_recurrence_reference``
(f32: autograd records through it; bf16: the plain bf16 version,
``lstm_bf16.chain_forward`` with its backward written out). On CUDA
tensors it launches ``csrc/lstm_recurrence.cu`` (built for H 64, 128,
192 and 256, any B and T; each step's product on the tensor cores, in
3xTF32 or, in the bf16 mode, bf16 ``mma.sync``); any other H up to 256
runs on the next of those sizes, its gate blocks, W_hh's rows, h0 and c0
padded with zero units and the outputs' padded units dropped
(``ops/hidden_pad.py``: exact; the padding is part of ``lstm_recurrence``
and the launches are the same). Where a gradient is needed, the forward
that saves the gate activations and cell states, then the backward
kernel (the reverse chain writes dxw, then a deterministic split-K
reduction gives dW_hh^T); otherwise the forward without residuals. A
cluster of CTAs runs 16 batch rows; its size per launch is
``launch_ctas`` (``ops/cluster_size.py``), from the occupancy of the
mode's own instantiation. H above 256 raises, naming K8. Launch
counters: ``fwd_launches`` (both f32 forwards), ``bwd_launches``,
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
# and 192, 16 and 32 units a CTA as at H 256 and 128)
CLUSTER_CTAS = {256: (16, 8), 192: (12, 6), 128: (8, 4), 64: (4, 2)}
_P = ctypes.c_void_p
_I = ctypes.c_int


_OPERANDS = ("xw", "w_hh_t", "h0", "c0")


def operand_dtype(name, args) -> torch.dtype:
    """The operand mode of (xw, w_hh_t, h0, c0): f32 or bf16
    (``lstm_bf16.recurrence_operand_dtype``)."""
    return lstm_bf16.recurrence_operand_dtype(f"{name} (K8)", args,
                                              _OPERANDS)


class _PlainBf16Recurrence(torch.autograd.Function):
    """The plain bf16 mode (``lstm_bf16.chain_forward``), its backward
    ``chain_backward`` and dW_hh = bf16(h_{t-1})^T bf16(dgates)."""

    @staticmethod
    def forward(ctx, xw, w_hh_t, h0, c0):
        ys, hn, cn, acts, cs = lstm_bf16.chain_forward(xw, w_hh_t, h0, c0)
        ctx.save_for_backward(w_hh_t, h0, c0, ys, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        w_hh_t, h0, c0, ys, acts, cs = ctx.saved_tensors
        dys, dhn, dcn = lstm_bf16.zero_none((dys, dhn, dcn), (ys, h0, c0))
        dgates, dh0, dc0 = lstm_bf16.chain_backward(
            acts, cs, c0, w_hh_t, dys.float(), dhn.float(), dcn.float())
        return (dgates, lstm_bf16.tn(lstm_bf16.shifted(ys, h0), dgates),
                dh0, dc0)


def lstm_recurrence_reference(xw, w_hh_t, h0, c0):
    """Plain PyTorch version: only h @ W_hh^T runs inside the time loop.
    In the bf16 mode (bf16 ``w_hh_t``) h rounds to bf16 at the product and
    the backward is the plain bf16 backward."""
    if w_hh_t.dtype == torch.bfloat16:
        operand_dtype("lstm_recurrence_reference", (xw, w_hh_t, h0, c0))
        ys, hn, cn = _PlainBf16Recurrence.apply(xw, w_hh_t, h0, c0)
        return ys, (hn, cn)
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
    """Why ``lstm_recurrence`` cannot take an LSTM of this hidden size on
    CUDA, or None: every H from 1 to 256 runs (on ``padded_hidden(H)``)."""
    if padded_hidden(hidden) is None:
        return (f"hidden size {hidden}: the K8 kernels take hidden sizes 1 "
                f"to {HIDDEN_SIZES[-1]} (built for {HIDDEN_SIZES}, the "
                "others padded with zero units to the next; a CTA of the "
                "cluster owns the i, f, g, o gate columns of 16 or 32 "
                "units and W_hh stays in the cluster's registers)")
    return None


def pad_args(args, hp: int):
    """(xw, w_hh_t, h0, c0) of hidden size H as hidden size ``hp`` >= H:
    each gate block of xw and of W_hh's columns, W_hh's rows, h0 and c0
    padded with zero units (``ops/hidden_pad.py``; differentiable)."""
    xw, w_hh_t, h0, c0 = args
    return (pad_gates(xw, 4, hp), pad_weight(w_hh_t, 4, hp),
            pad_units(h0, hp), pad_units(c0, hp))


def unpad_outputs(ys, hn, cn, h: int):
    """(ys, h_n, c_n) of a padded run cut to the first ``h`` units."""
    return tuple(unpad_units(x, h) for x in (ys, hn, cn))


def _lib():
    lib = _build.load("lstm_recurrence")
    if not getattr(lib, "_typed", False):
        lib.lstm_recurrence_backward_workspace_floats.argtypes = [_I] * 3
        lib.lstm_recurrence_backward_workspace_floats.restype = (
            ctypes.c_longlong)
        for mode in ("f32", "bf16"):
            query = getattr(lib, "lstm_recurrence_resident_clusters"
                            + ("_bf16" if mode == "bf16" else ""))
            query.argtypes = [_I] * 2
            query.restype = ctypes.c_int
            fwd = getattr(lib, f"lstm_recurrence_forward_{mode}")
            bwd = getattr(lib, f"lstm_recurrence_backward_{mode}")
            fwd.argtypes = [_P] * 9 + [_I] * 4 + [_P]
            bwd.argtypes = [_P] * 14 + [_I] * 4 + [_P]
            fwd.restype = bwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_ctas(device, b: int, h: int, bf16: bool = False) -> int:
    """CTAs per cluster of a launch of the f32 or the bf16 mode on this
    CUDA device: the first size of ``CLUSTER_CTAS[h]`` at which the card
    holds the batch's clusters of that mode's kernels at once
    (``cluster_size.launch_ctas``)."""
    return cluster_size.launch_ctas(
        f"lstm_recurrence H{h}" + (" bf16" if bf16 else ""), device, b,
        CLUSTER_CTAS[h],
        lambda ctas: (_lib().lstm_recurrence_resident_clusters_bf16 if bf16
                      else _lib().lstm_recurrence_resident_clusters)(h, ctas))


def _check(name, xw, w_hh_t, h0, c0, **more):
    """Raise unless the kernels take these tensors: one operand mode
    (``operand_dtype``; the further tensors f32), contiguous, on one CUDA
    device, shapes from xw (B, T, 4H); ``more`` maps each further tensor
    to its expected shape as a function of (B, T, H). Returns (B, T, H,
    bf16 mode)."""
    if xw.device.type != "cuda":
        raise ValueError(f"{name}: no K8 kernel for {xw.device}")
    bf16 = operand_dtype(name, (xw, w_hh_t, h0, c0)) == torch.bfloat16
    if xw.dim() != 3 or xw.shape[2] % 4:
        raise ValueError(f"{name}: K8 takes xw (B, T, 4H), got "
                         f"{tuple(xw.shape)}")
    b, t, g4 = xw.shape
    h = g4 // 4
    want = dict(xw=(xw, (b, t, g4)), w_hh_t=(w_hh_t, (h, g4)),
                h0=(h0, (b, h)), c0=(c0, (b, h)))
    want.update({k: (v, tuple(s(b, t, h))) for k, (v, s) in more.items()})
    for key, (a, shape) in want.items():
        if a.device != xw.device or (key != "w_hh_t"
                                     and a.dtype != torch.float32):
            raise ValueError(
                f"{name}: the K8 kernels take tensors on one CUDA device, "
                f"f32 but w_hh_t; got {key} {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: K8 expects {key} contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})")
    why = f"B {b}, T {t}"
    if b >= 1 and t >= 1:
        why = kernel_refusal(h) or unbuilt(h, "K8", "lstm_recurrence")
    if why is not None:
        raise ValueError(f"{name}: no K8 kernel for {why}")
    return b, t, h, bf16


def lstm_recurrence_forward(args, residuals: bool):
    """The forward kernel (CUDA only), in the operand mode of ``args``.
    Returns (ys, hn, cn, acts, cs); acts (B, T, 4H) and cs (B, T, H) are
    the backward's residuals, None unless ``residuals``."""
    b, t, h, bf16 = _check("lstm_recurrence_forward", *args)
    ctas = launch_ctas(args[0].device, b, h, bf16)
    xw = args[0]
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=xw.device)
    ys, hn, cn = new(b, t, h), new(b, h), new(b, h)
    acts = new(b, t, 4 * h) if residuals else None
    cs = new(b, t, h) if residuals else None
    lib = _lib()
    fn = (lib.lstm_recurrence_forward_bf16 if bf16
          else lib.lstm_recurrence_forward_f32)
    _build.launch(fn, *args, ys, hn, cn, acts, cs, dims=(b, t, h, ctas))
    global fwd_launches, bf16_fwd_launches
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return ys, hn, cn, acts, cs


def lstm_recurrence_backward(args, ys, acts, cs, dys, dhn, dcn):
    """The backward kernel (CUDA only), from the forward's residuals.
    Returns (dxw, dw_hh_t, dh0, dc0), each in its input's dtype."""
    xw, w_hh_t, h0, c0 = args
    # the dW_hh reduction reads ys and h0 16 bytes at a time
    ys, h0 = [a.clone() if a.data_ptr() % 16 else a for a in (ys, h0)]
    cots = [c.float().contiguous() for c in (dys, dhn, dcn)]
    b, t, h, bf16 = _check("lstm_recurrence_backward", *args,
                     ys=(ys, lambda b, t, h: (b, t, h)),
                     acts=(acts, lambda b, t, h: (b, t, 4 * h)),
                     cs=(cs, lambda b, t, h: (b, t, h)),
                     dys=(cots[0], lambda b, t, h: (b, t, h)),
                     dhn=(cots[1], lambda b, t, h: (b, h)),
                     dcn=(cots[2], lambda b, t, h: (b, h)))
    ctas = launch_ctas(xw.device, b, h, bf16)
    grads = [torch.empty_like(a) for a in args]
    lib = _lib()
    ws = torch.empty(lib.lstm_recurrence_backward_workspace_floats(b, t, h),
                     dtype=torch.float32, device=xw.device)
    fn = (lib.lstm_recurrence_backward_bf16 if bf16
          else lib.lstm_recurrence_backward_f32)
    _build.launch(fn, w_hh_t, h0, c0, ys, acts, cs, *cots, *grads, ws,
                  dims=(b, t, h, ctas))
    global bwd_launches, bf16_bwd_launches
    if bf16:
        bf16_bwd_launches += 1
    else:
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
        return lstm_recurrence_backward(
            args, ys, acts, cs, *lstm_bf16.zero_none(
                (dys, dhn, dcn), (ys, args[2], args[3])))


def lstm_recurrence(
    xw: torch.Tensor,      # (B, T, 4H) f32
    w_hh_t: torch.Tensor,  # (H, 4H) f32, or bf16 in the bf16 mode
    h0: torch.Tensor, c0: torch.Tensor,  # (B, H) f32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The LSTM recurrence, differentiable; ``w_hh_t``'s dtype picks the
    operand mode. CPU tensors take the plain version, CUDA tensors the
    kernels: a hidden size they are not built for on its arguments padded
    to ``padded_hidden`` (``pad_args``), the outputs cut back
    (``unpad_outputs``); above 256 it raises, naming K8."""
    args = (xw, w_hh_t, h0, c0)
    if xw.device.type == "cpu":
        return lstm_recurrence_reference(*args)
    h = h0.shape[-1]
    hp = padded_hidden(h) or h
    if hp != h and xw.shape[-1] == 4 * h:
        args = pad_args(args, hp)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn, cn = _LstmRecurrence.apply(*args)
    else:
        ys, hn, cn, _, _ = lstm_recurrence_forward(args, residuals=False)
    ys, hn, cn = unpad_outputs(ys, hn, cn, h)
    return ys, (hn, cn)
