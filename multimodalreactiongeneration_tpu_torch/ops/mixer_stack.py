"""Recurrent-mixer block stack, forward: CUDA kernel and plain version.

Counterpart of ``mixer_stack_recurrence`` in ``multimodalreactiongeneration
_tpu/ops/pallas_mixer_stack.py`` (its primal, the light forward), with
the same signature and layouts. Each of the L blocks computes
LSTM -> +x -> LayerNorm -> Dense(H->H) -> +res -> LayerNorm; the stack
returns the top block's output and every block's final (h, c).

``mixer_stack_forward`` launches ``csrc/mixer_stack.cu`` for CUDA
tensors (f32 only; the kernel's design is in its source note) and runs
``mixer_stack_forward_reference`` for CPU tensors. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from multimodalreactiongeneration_tpu_torch.nn.basic import layer_norm

launches = 0

_MAX_H = 256


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype, accumulated in f32."""
    return a.to(w.dtype).float() @ w.float()


def mixer_stack_forward_reference(
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version; arguments as ``mixer_stack_forward``."""
    x = x0.float()
    hn, cn = [], []
    for l in range(w_hh_t.shape[0]):
        xw = _mm(x, w_ih_t[l]) + b_g[l]
        h, c = h0[l].float(), c0[l].float()
        ys = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + _mm(h, w_hh_t[l])
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        hn.append(h)
        cn.append(c)
        y = layer_norm(torch.stack(ys, dim=1) + x, g1[l], b1[l])
        x = layer_norm(_mm(y, w_ff[l]) + b_ff[l] + y, g2[l], b2[l])
    return x, (torch.stack(hn), torch.stack(cn))


def _lib():
    from multimodalreactiongeneration_tpu_torch import _build

    lib = _build.load("mixer_stack")
    if not getattr(lib, "_typed", False):
        lib.mixer_stack_forward_f32.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.mixer_stack_forward_f32.restype = ctypes.c_int
        lib.mixer_stack_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.mixer_stack_workspace_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def mixer_stack_forward(
    x0: torch.Tensor,      # (B, T, H) f32
    w_ih_t: torch.Tensor,  # (L, H, 4H)
    b_g: torch.Tensor,     # (L, 4H)  b_ih + b_hh
    w_hh_t: torch.Tensor,  # (L, H, 4H)
    w_ff: torch.Tensor,    # (L, H, H) Dense kernels, (in, out)
    b_ff: torch.Tensor,    # (L, H)
    g1: torch.Tensor, b1: torch.Tensor,  # (L, H) mixer_norm
    g2: torch.Tensor, b2: torch.Tensor,  # (L, H) feed_forward LN
    h0: torch.Tensor, c0: torch.Tensor,  # (L, B, H) f32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out_top (B, T, H), (h_n (L, B, H), c_n (L, B, H)))."""
    args = (x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0)
    if x0.device.type == "cpu":
        return mixer_stack_forward_reference(*args)
    if x0.device.type != "cuda":
        raise ValueError(f"mixer_stack_forward: no kernel for {x0.device}")
    b, t, h = x0.shape
    nl = w_hh_t.shape[0]
    shapes = (
        (b, t, h), (nl, h, 4 * h), (nl, 4 * h), (nl, h, 4 * h), (nl, h, h),
        (nl, h), (nl, h), (nl, h), (nl, h), (nl, h), (nl, b, h), (nl, b, h),
    )
    for a, shape in zip(args, shapes):
        if a.device != x0.device or a.dtype != torch.float32:
            raise ValueError(
                "mixer_stack_forward kernel takes f32 tensors on one CUDA "
                f"device; got {a.dtype} on {a.device}"
            )
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"mixer_stack_forward: expected contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})"
            )
    if h % 64 or h > _MAX_H:
        raise ValueError(
            f"mixer_stack_forward kernel takes H a multiple of 64 up to "
            f"{_MAX_H}; got {h}"
        )
    lib = _lib()
    out = torch.empty_like(x0)
    hn = torch.empty_like(h0)
    cn = torch.empty_like(c0)
    ws = torch.empty(
        lib.mixer_stack_workspace_floats(b, t, h),
        dtype=torch.float32, device=x0.device,
    )
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    with torch.cuda.device(x0.device):
        rc = lib.mixer_stack_forward_f32(
            *[a.data_ptr() for a in args],
            out.data_ptr(), hn.data_ptr(), cn.data_ptr(), ws.data_ptr(),
            b, t, h, nl, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mixer_stack kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out, (hn, cn)
