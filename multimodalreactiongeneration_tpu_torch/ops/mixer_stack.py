"""Recurrent-mixer block stack: CUDA kernels, autograd and plain version.

Counterpart of ``mixer_stack_recurrence`` in ``multimodalreactiongeneration
_tpu/ops/pallas_mixer_stack.py``, with the same signature and layouts.
Each of the L blocks computes LSTM -> +x -> LayerNorm -> Dense(H->H) ->
+res -> LayerNorm; the stack returns the top block's output and every
block's final (h, c).

Two operand modes, as JAX's kernel takes them: every tensor f32, or
JAX's bf16 mode (``nn/mixers.py`` passes the stacked weights in the
parameters' dtype): ``w_ih_t``, ``w_hh_t`` and ``w_ff`` bf16, every other
input f32. Then each product rounds its activation operand to bf16 (x,
h, y; in the backward the cotangents dgates and dr2) and sums in f32;
the states, cell math, LayerNorms and outputs stay f32. dW_ih, dW_hh and
dW_ff come back bf16, rounded once from their f32 sums; dx0, db and the
LayerNorm and state gradients f32. Any other mix of dtypes raises.

``mixer_stack_recurrence`` is the entry point. On CPU tensors it runs
``mixer_stack_forward_reference`` (autograd records through it; in the
bf16 mode through ``ops/lstm_bf16.py operand_mm``, which rounds where
JAX's backward rounds). On CUDA tensors, where a gradient is needed, the
autograd function runs the training forward (``mixer_stack_train_
forward``, which stores residuals) and the backward kernel
(``mixer_stack_backward``); otherwise the inference forward
(``mixer_stack_forward``, f32 only: K1's bf16 mode waits in ROADMAP Queue
B item 1). All three launch ``csrc/mixer_stack.cu`` (the design is in its
source note). Launch counters: ``launches`` (inference forward),
``train_fwd_launches`` and ``bwd_launches``, and the bf16 mode's
``bf16_train_fwd_launches`` and ``bf16_bwd_launches``.

The two forwards run the layers as a layer-lagged chunk schedule on
per-layer CUDA streams: layer l runs chunk c (``chunk`` steps) once layer
l-1 has finished it. ``chunk_steps`` picks the chunk; ``chunk=T`` is the
layer-major schedule, and every chunk gives the same bits. The backward
runs the same schedule in reverse (the last chunk first, layer l after
layer l+1); its input and state cotangents are the same bits at every
chunk, its parameter gradients sum the chunks in another order.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.nn.basic import layer_norm
from multimodalreactiongeneration_tpu_torch.ops.lstm_bf16 import operand_mm

launches = 0
train_fwd_launches = 0
bwd_launches = 0
bf16_train_fwd_launches = 0
bf16_bwd_launches = 0

_MAX_H = 256
_P = ctypes.c_void_p
_I = ctypes.c_int

ROWS = 16  # batch rows per cluster of the recurrence (csrc STACK_ROWS)
# Chunk lengths measured fastest on an H100 at H256 x L5 (PERF.md §6,
# PR 10): 64 steps at T2016-T2096 and 32 at T252-T262, for B16 to B64.
LONG_CHUNK, SHORT_CHUNK, LONG_T = 64, 32, 1024


def chunk_steps(b: int, t: int, h: int, layers: int) -> int:
    """Steps per chunk of the stack forward at batch b, t steps, width h
    and ``layers`` blocks. One layer has no lag to hide: t, one chunk.
    Otherwise LONG_CHUNK from LONG_T steps on and SHORT_CHUNK below, at
    most t: a short chunk adds launches and a W_hh prologue per chunk, a
    long one adds (layers - 1) * chunk steps to the chain."""
    if min(b, t, h, layers) < 1:
        raise ValueError(f"chunk_steps: b {b}, t {t}, h {h}, layers {layers}")
    if layers == 1:
        return t
    return min(t, LONG_CHUNK if t >= LONG_T else SHORT_CHUNK)


# The backward's chunk lengths, measured fastest on an H100 at B32 x H256 x
# L5 (PERF.md §6, the K4 sweep): 128 steps at T2016 and 64 at T252. Its
# chunks carry more work than the forward's (the weight-gradient reductions
# on a side stream, which bound it), so its chunks are twice as long.
BWD_LONG_CHUNK, BWD_SHORT_CHUNK = 128, 64


def backward_chunk_steps(b: int, t: int, h: int, layers: int) -> int:
    """Steps per chunk of the stack backward: the rule of ``chunk_steps``
    (one layer: t; else the long chunk from LONG_T steps on and the short
    one below, at most t) with BWD_LONG_CHUNK and BWD_SHORT_CHUNK."""
    if min(b, t, h, layers) < 1:
        raise ValueError(
            f"backward_chunk_steps: b {b}, t {t}, h {h}, layers {layers}")
    if layers == 1:
        return t
    return min(t, BWD_LONG_CHUNK if t >= LONG_T else BWD_SHORT_CHUNK)


_WEIGHTS = (1, 3, 4)  # w_ih_t, w_hh_t, w_ff


def operand_dtype(name, args) -> torch.dtype:
    """The operand mode of the twelve arguments: f32 when every tensor is
    f32, bf16 for JAX's bf16 mode (w_ih_t, w_hh_t and w_ff bf16, the rest
    f32); raises, naming ``name``, otherwise."""
    mm = args[3].dtype
    want = [mm if i in _WEIGHTS else torch.float32 for i in range(12)]
    if mm not in (torch.float32, torch.bfloat16) or any(
            a.dtype != d for a, d in zip(args, want)):
        raise ValueError(
            f"{name} (K3/K4) takes every tensor f32, or w_ih_t, w_hh_t and "
            "w_ff bf16 with the rest f32 (the bf16 operand mode); got "
            + ", ".join(str(a.dtype) for a in args))
    return mm


def mixer_stack_forward_reference(
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version; arguments as ``mixer_stack_recurrence``. In
    the bf16 mode every product is ``operand_mm``: bf16 operands, f32 sums,
    and under autograd JAX's rounding of the cotangents."""
    args = (x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0)
    if operand_dtype("mixer_stack_forward_reference", args) == torch.float32:
        mm = torch.matmul
    else:  # the bf16 weights converted once: their gradients sum in f32
        mm = operand_mm
        w_ih_t, w_hh_t, w_ff = w_ih_t.float(), w_hh_t.float(), w_ff.float()
    x = x0
    hn, cn = [], []
    for l in range(w_hh_t.shape[0]):
        xw = mm(x, w_ih_t[l]) + b_g[l]
        h, c = h0[l], c0[l]
        ys = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + mm(h, w_hh_t[l])
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        hn.append(h)
        cn.append(c)
        y = layer_norm(torch.stack(ys, dim=1) + x, g1[l], b1[l])
        x = layer_norm(mm(y, w_ff[l]) + b_ff[l] + y, g2[l], b2[l])
    return x, (torch.stack(hn), torch.stack(cn))


def mixer_stack_backward_reference(args, dout, dhn, dcn, closure=False):
    """Plain backward: ``torch.autograd.grad`` through the plain forward.
    Returns the twelve input gradients, in argument order; with
    ``closure=True``, a function that computes them again and again from
    the graph recorded once, so the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        out, (hn, cn) = mixer_stack_forward_reference(*leaves)

    def grads():
        return torch.autograd.grad((out, hn, cn), leaves, (dout, dhn, dcn),
                                   retain_graph=closure)
    return grads if closure else grads()


def _lib():
    lib = _build.load("mixer_stack")
    if not getattr(lib, "_typed", False):
        for name, n in (("mixer_stack_workspace_floats", 5),
                        ("mixer_stack_train_workspace_floats", 5),
                        ("mixer_stack_backward_workspace_floats", 5),
                        ("mixer_stack_residual_floats", 4)):
            getattr(lib, name).argtypes = [_I] * n
            getattr(lib, name).restype = ctypes.c_longlong
        lib.mixer_stack_resident_clusters.argtypes = [_I]
        lib.mixer_stack_resident_clusters.restype = _I
        lib.mixer_stack_forward_f32.argtypes = [_P] * 16 + [_I] * 5 + [_P]
        lib.mixer_stack_train_forward_f32.argtypes = (
            [_P] * 17 + [_I] * 5 + [_P])
        lib.mixer_stack_backward_f32.argtypes = [_P] * 25 + [_I] * 5 + [_P]
        lib.mixer_stack_train_forward_bf16.argtypes = (
            [_P] * 17 + [_I] * 5 + [_P])
        lib.mixer_stack_backward_bf16.argtypes = [_P] * 26 + [_I] * 5 + [_P]
        lib.mixer_stack_backward_bf16_sum_floats.argtypes = [_I] * 2
        lib.mixer_stack_backward_bf16_sum_floats.restype = ctypes.c_longlong
        for name in ("mixer_stack_forward_f32",
                     "mixer_stack_train_forward_f32",
                     "mixer_stack_backward_f32",
                     "mixer_stack_train_forward_bf16",
                     "mixer_stack_backward_bf16"):
            getattr(lib, name).restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_args(name, args):
    """The kernels' contract: contiguous tensors of one operand mode on one
    CUDA device, shapes as ``mixer_stack_recurrence`` documents, H 128 or
    256. Returns (B, T, H, L, bf16 mode)."""
    x0, w_hh_t = args[0], args[3]
    if x0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x0.device}")
    bf16 = operand_dtype(name, args) == torch.bfloat16
    b, t, h = x0.shape
    nl = w_hh_t.shape[0]
    shapes = (
        (b, t, h), (nl, h, 4 * h), (nl, 4 * h), (nl, h, 4 * h), (nl, h, h),
        (nl, h), (nl, h), (nl, h), (nl, h), (nl, h), (nl, b, h), (nl, b, h),
    )
    for a, shape in zip(args, shapes):
        if a.device != x0.device:
            raise ValueError(
                f"{name} kernel takes tensors on one CUDA device; got "
                f"{a.device} beside {x0.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {shape}, got {tuple(a.shape)} "
                f"(contiguous={a.is_contiguous()})"
            )
    if h % 128 or h > _MAX_H:
        raise ValueError(
            f"{name} kernel takes H a multiple of 128 up to {_MAX_H}; got {h}"
        )
    return b, t, h, nl, bf16


def _empty(n, like):
    return torch.empty(n, dtype=torch.float32, device=like.device)


def _chunk(name, b, t, h, nl, chunk, backward=False):
    """The chunk of a launch: ``chunk`` steps (None: ``chunk_steps``, or
    ``backward_chunk_steps``) from 1 to t; raises on others."""
    if chunk is None:
        rule = backward_chunk_steps if backward else chunk_steps
        chunk = rule(b, t, h, nl)
    if not 1 <= chunk <= t:
        raise ValueError(f"{name}: chunk of {chunk} steps; takes 1 to {t}")
    return chunk


def resident_clusters(h: int, device=None) -> int:
    """Clusters of ROWS batch rows the card holds at once in the forward
    recurrence at width h (the occupancy query)."""
    with torch.cuda.device(device):
        return _lib().mixer_stack_resident_clusters(h)


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
    *, chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The inference forward. Returns (out_top (B, T, H), (h_n (L, B, H),
    c_n (L, B, H))). It records no autograd graph, so it refuses inputs
    that need a gradient (``mixer_stack_recurrence`` takes those).
    ``chunk`` steps per chunk (None: ``chunk_steps``; T: layer-major)."""
    args = (x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise RuntimeError(
            "mixer_stack_forward records no gradient; call "
            "mixer_stack_recurrence for inputs that require grad"
        )
    if x0.device.type == "cpu":
        return mixer_stack_forward_reference(*args)
    b, t, h, nl, bf16 = _check_args("mixer_stack_forward", args)
    if bf16:
        raise NotImplementedError(
            "mixer_stack_forward (K1) has no bf16 operand mode yet (ROADMAP "
            "Queue B item 1); the bf16 training step runs the stack under "
            "gradient (K3/K4)")
    chunk = _chunk("mixer_stack_forward", b, t, h, nl, chunk)
    lib = _lib()
    out = torch.empty_like(x0)
    hn = torch.empty_like(h0)
    cn = torch.empty_like(c0)
    ws = _empty(lib.mixer_stack_workspace_floats(b, t, h, nl, chunk), x0)
    _build.launch(lib.mixer_stack_forward_f32, *args, out, hn, cn, ws,
                  dims=(b, t, h, nl, chunk))
    global launches
    launches += 1
    return out, (hn, cn)


def mixer_stack_train_forward(*args, chunk=None):
    """The training forward kernel (CUDA only), in the arguments' operand
    mode: returns (out, hn, cn, res), ``res`` the flat residual buffer
    ``mixer_stack_backward`` reads; ``chunk`` as ``mixer_stack_forward``."""
    b, t, h, nl, bf16 = _check_args("mixer_stack_train_forward", args)
    chunk = _chunk("mixer_stack_train_forward", b, t, h, nl, chunk)
    x0, h0 = args[0], args[10]
    lib = _lib()
    out = torch.empty_like(x0)
    hn = torch.empty_like(h0)
    cn = torch.empty_like(h0)
    res = _empty(lib.mixer_stack_residual_floats(b, t, h, nl), x0)
    ws = _empty(lib.mixer_stack_train_workspace_floats(b, t, h, nl, chunk),
                x0)
    fn = (lib.mixer_stack_train_forward_bf16 if bf16
          else lib.mixer_stack_train_forward_f32)
    _build.launch(fn, *args, out, hn, cn, res, ws, dims=(b, t, h, nl, chunk))
    global train_fwd_launches, bf16_train_fwd_launches
    if bf16:
        bf16_train_fwd_launches += 1
    else:
        train_fwd_launches += 1
    return out, hn, cn, res


def mixer_stack_backward(args, res, dout, dhn, dcn, *, chunk=None):
    """The backward kernel (CUDA only), from the training forward's
    residuals. Returns the twelve input gradients, in argument order, each
    in its input's dtype. ``chunk`` steps per chunk (None:
    ``backward_chunk_steps``; T: layer-major)."""
    b, t, h, nl, bf16 = _check_args("mixer_stack_backward", args)
    chunk = _chunk("mixer_stack_backward", b, t, h, nl, chunk,
                   backward=True)
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0 = args
    # the tensor-core products read these 16 bytes at a time
    x0, w_ih_t, w_ff, h0 = (a if a.data_ptr() % 16 == 0 else a.clone()
                            for a in (x0, w_ih_t, w_ff, h0))
    cots = [c.float().contiguous() for c in (dout, dhn, dcn)]
    for c, like in zip(cots, (x0, h0, c0)):
        if c.shape != like.shape or c.device != like.device:
            raise ValueError(
                f"mixer_stack_backward: cotangent {tuple(c.shape)} on "
                f"{c.device} for {tuple(like.shape)} on {like.device}")
    grads = [torch.empty_like(a) for a in (
        x0, h0, c0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2)]
    lib = _lib()
    ws = _empty(lib.mixer_stack_backward_workspace_floats(b, t, h, nl, chunk),
                x0)
    global bwd_launches, bf16_bwd_launches
    if bf16:
        sums = _empty(lib.mixer_stack_backward_bf16_sum_floats(h, nl), x0)
        _build.launch(lib.mixer_stack_backward_bf16, x0, w_ih_t, w_hh_t, w_ff,
                      g1, g2, h0, c0, res, *cots, *grads, ws, sums,
                      dims=(b, t, h, nl, chunk))
        bf16_bwd_launches += 1
    else:
        _build.launch(lib.mixer_stack_backward_f32, x0, w_ih_t, w_hh_t, w_ff,
                      g1, g2, h0, c0, res, *cots, *grads, ws,
                      dims=(b, t, h, nl, chunk))
        bwd_launches += 1
    dx0, dh0, dc0, dwih, dbg, dwhh, dwff, dbff, dg1, db1, dg2, db2 = grads
    return (dx0, dwih, dbg, dwhh, dwff, dbff, dg1, db1, dg2, db2, dh0, dc0)


class _MixerStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        out, hn, cn, res = mixer_stack_train_forward(*args)
        ctx.save_for_backward(*args, res)
        return out, hn, cn

    @staticmethod
    def backward(ctx, dout, dhn, dcn):
        *args, res = ctx.saved_tensors
        dout, dhn, dcn = (
            torch.zeros_like(like) if c is None else c
            for c, like in zip((dout, dhn, dcn), (args[0], args[10], args[11]))
        )
        return mixer_stack_backward(args, res, dout, dhn, dcn)


def mixer_stack_recurrence(
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The stack, differentiable: arguments and result as
    ``mixer_stack_forward``; the weights' dtype picks the operand mode. CPU
    tensors take the plain version; CUDA tensors the kernels (training
    forward and backward where a gradient is needed, the inference forward
    otherwise)."""
    args = (x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0)
    if x0.device.type == "cpu":
        return mixer_stack_forward_reference(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        out, hn, cn = _MixerStack.apply(*args)
        return out, (hn, cn)
    return mixer_stack_forward(*args)
