"""Stacked unidirectional LSTM as one wavefront: CUDA kernels, autograd
and plain version.

Counterpart of ``lstm_stacked_recurrence`` in ``multimodalreactiongeneration
_tpu/ops/pallas_lstm_stacked.py``, same signature and layouts: ``xw0``
(B, T, 4H) = x @ W_ih_0^T + b_ih_0 + b_hh_0, ``w_ih_t`` (L-1, H, 4H) the
input projections of layers 1..L-1 transposed, ``b_rest`` (L-1, 4H) their
b_ih + b_hh, ``w_hh_t`` (L, H, 4H), ``h0``/``c0`` (L, B, H) (torch's
state layout); gate order i, f, g, o. Returns (ys of the top layer
(B, T, H), (h_n, c_n) each (L, B, H)).

Two operand modes, as JAX's: every tensor f32, or JAX's bf16 mode, where
``w_ih_t`` and ``w_hh_t`` are bf16 and select bf16 operands for every
product (``ops/lstm_bf16.py``) while ``xw0``, ``b_rest``, ``h0`` and
``c0`` stay f32. ys, h_n and c_n are f32; in the bf16 mode dW_ih and
dW_hh come back bf16 (the weights' dtype), dxw0, db and the state
cotangents f32. Any other mix raises.

On CPU tensors ``lstm_stacked_recurrence`` runs ``lstm_stacked_reference``
(f32: autograd records through it; bf16: its backward is the plain bf16
backward). On CUDA tensors it launches one of two routes (``route``):

  * "wavefront", H 128 at L 2 or 3 (any B; H 65 to 127 run padded to
    128 there): ``csrc/lstm_stacked.cu``, the
    whole stack in one cluster's shared memory (the f32 or the bf16
    instantiation). It runs R batch rows per cluster, the smallest R the
    card holds in one wave (``cluster_rows.choose_rows``, on the layout
    of the mode; L 3 takes only 16), or the ``rows`` a caller names.
    Launch counters: ``fwd_launches`` (both f32 forwards),
    ``bwd_launches``, ``bf16_fwd_launches`` and ``bf16_bwd_launches``.
  * "layers", every other H up to 256 at any L >= 2 (any B): the stacks
    whose weights one cluster cannot hold (H 256, H 128 past 3 layers)
    and the hidden sizes the wavefront is not built for (H 1 to 64, 129 to
    256), as a layer-lagged
    window schedule of K8's chains on a stream a layer, the input
    products and weight gradients on the repo's tensor-core GEMMs
    (``csrc/lstm_recurrence.cu`` ``lstm_stacked_layers_*``); C steps a
    window (``layers_chunk``, or the ``chunk`` a caller names: C = T runs
    the layers one after the other, the same bits), CTAs per cluster of
    the chains from ``lstm_recurrence.launch_ctas``. Launch counters:
    ``layers_fwd_launches``, ``layers_bwd_launches``,
    ``layers_bf16_fwd_launches`` and ``layers_bf16_bwd_launches``. K8's
    chains are built for H 64, 128, 192 and 256; any other H runs on the
    next of them, ``lstm_stacked_recurrence`` padding xw0's, w_ih_t's,
    w_hh_t's and b_rest's gate blocks, the weights' rows, h0 and c0 with
    zero units and cutting the outputs back (``pad_args``,
    ``ops/hidden_pad.py``: exact, as a padded unit's h stays 0 and its
    input product reads only zeros).

Both routes take the same residual layout (hs (L-1, B, T, H), acts (L,
B, T, 4H), cs (L, B, T, H)). Where a gradient is needed the wrapper
launches the forward that stores them and then the backward; otherwise
the forward without residuals. H above 256 and fewer than 2 layers
raise, naming K9.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from multimodalreactiongeneration_tpu_torch import _build
from multimodalreactiongeneration_tpu_torch.ops import lstm_bf16
from multimodalreactiongeneration_tpu_torch.ops import (
    lstm_recurrence as k8,
)
from multimodalreactiongeneration_tpu_torch.ops.cluster_rows import (
    card_layout,
    resolve_rows,
)
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
layers_fwd_launches = 0
layers_bwd_launches = 0
layers_bf16_fwd_launches = 0
layers_bf16_bwd_launches = 0

HIDDEN = 128       # the hidden size the wavefront takes
MAX_LAYERS = 3     # the most layers whose weights fit one 8-CTA cluster
_P = ctypes.c_void_p
_I = ctypes.c_int


def operand_dtype(name, args) -> torch.dtype:
    """The operand mode of (xw0, w_ih_t, b_rest, w_hh_t, h0, c0): f32 when
    every tensor is f32, bf16 for JAX's bf16 mode (both weights bf16, the
    rest f32); raises, naming ``name``, otherwise."""
    mm = args[3].dtype
    f32 = torch.float32
    want = (f32, mm, f32, mm, f32, f32)
    if mm not in (f32, torch.bfloat16) or any(
            a.dtype != d for a, d in zip(args, want)):
        raise ValueError(
            f"{name} (K9) takes every tensor f32, or w_ih_t and w_hh_t "
            "bf16 with xw0, b_rest, h0 and c0 f32 (the bf16 operand mode); "
            "got " + ", ".join(str(a.dtype) for a in args))
    return mm


def _bf16_forward(xw0, w_ih_t, b_rest, w_hh_t, h0, c0):
    """The plain bf16 mode, layer by layer: (ys, hn, cn, ys_all, acts,
    cs); ys_all (L, B, T, H), acts (L, B, T, 4H) and cs (L, B, T, H) are
    the backward's residuals. All f32."""
    x, outs = xw0, []
    for layer in range(w_hh_t.shape[0]):
        if layer > 0:
            x = (lstm_bf16.round_bf16(outs[-1][0]) @ w_ih_t[layer - 1].float()
                 + b_rest[layer - 1])
        outs.append(lstm_bf16.chain_forward(x, w_hh_t[layer], h0[layer],
                                            c0[layer]))
    ys_all, hn, cn, acts, cs = (torch.stack(o) for o in zip(*outs))
    return ys_all[-1], hn, cn, ys_all, acts, cs


def _bf16_backward(args, ys_all, acts, cs, dys, dhn, dcn):
    """The plain bf16 mode's gradients (dxw0, dw_ih_t, db_rest, dw_hh_t,
    dh0, dc0), top layer first: a layer's dy is bf16(dgates of the layer
    above) W_ih^T."""
    xw0, w_ih_t, b_rest, w_hh_t, h0, c0 = args
    layers = w_hh_t.shape[0]
    dwih, db = [None] * (layers - 1), [None] * (layers - 1)
    dwhh, dh0, dc0 = [None] * layers, [None] * layers, [None] * layers
    dy = dys.float()
    for l in reversed(range(layers)):
        dg, dh0[l], dc0[l] = lstm_bf16.chain_backward(
            acts[l], cs[l], c0[l], w_hh_t[l], dy, dhn[l].float(),
            dcn[l].float())
        dwhh[l] = lstm_bf16.tn(lstm_bf16.shifted(ys_all[l], h0[l]), dg)
        if l > 0:
            dwih[l - 1] = lstm_bf16.tn(ys_all[l - 1], dg)
            db[l - 1] = dg.sum((0, 1))
            dy = lstm_bf16.round_bf16(dg) @ w_ih_t[l - 1].float().T
    stack = lambda xs, like: torch.stack(xs) if xs else torch.zeros_like(like)
    return (dg, stack(dwih, w_ih_t), stack(db, b_rest), torch.stack(dwhh),
            torch.stack(dh0), torch.stack(dc0))


class _PlainBf16Stacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, cn, ys_all, acts, cs = _bf16_forward(*args)
        ctx.save_for_backward(*args, ys_all, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        *args, ys_all, acts, cs = ctx.saved_tensors
        return _bf16_backward(args, ys_all, acts, cs, *lstm_bf16.zero_none(
            (dys, dhn, dcn), (ys_all[-1], args[4], args[5])))


def lstm_stacked_reference(xw0, w_ih_t, b_rest, w_hh_t, h0, c0):
    """Plain PyTorch version, layer by layer: the JAX test's ground truth
    (``tests/test_pallas_lstm_stacked.py _scan_stack_ref``). In the bf16
    mode (bf16 ``w_hh_t``) every product rounds its operands to bf16 and
    the backward is the plain bf16 backward (``ops/lstm_bf16.py``)."""
    if w_hh_t.dtype == torch.bfloat16:
        args = (xw0, w_ih_t, b_rest, w_hh_t, h0, c0)
        operand_dtype("lstm_stacked_reference", args)
        ys, hn, cn = _PlainBf16Stacked.apply(*args)
        return ys, (hn, cn)
    x = xw0
    hns, cns = [], []
    for layer in range(w_hh_t.shape[0]):
        if layer > 0:
            x = x @ w_ih_t[layer - 1] + b_rest[layer - 1]
        x, (hn, cn) = k8.lstm_recurrence_reference(x, w_hh_t[layer],
                                                   h0[layer], c0[layer])
        hns.append(hn)
        cns.append(cn)
    return x, (torch.stack(hns), torch.stack(cns))


def lstm_stacked_backward_reference(args, dys, dhn, dcn, closure=False):
    """Plain backward: ``torch.autograd.grad`` through the plain forward.
    Returns (dxw0, dw_ih_t, db_rest, dw_hh_t, dh0, dc0); with
    ``closure=True``, a function that computes them again and again from
    the graph recorded once, so the backward can be timed alone."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in args]
        ys, (hn, cn) = lstm_stacked_reference(*leaves)

    def grads():
        return torch.autograd.grad((ys, hn, cn), leaves, (dys, dhn, dcn),
                                   retain_graph=closure)
    return grads if closure else grads()


def _lib():
    lib = _build.load("lstm_stacked")
    if not getattr(lib, "_typed", False):
        lib.lstm_stacked_backward_workspace_floats.argtypes = []
        lib.lstm_stacked_backward_workspace_floats.restype = ctypes.c_longlong
        lib.lstm_stacked_smem_bytes.argtypes = [_I] * 4
        lib.lstm_stacked_smem_bytes.restype = ctypes.c_longlong
        for mode in ("f32", "bf16"):
            fwd = getattr(lib, f"lstm_stacked_forward_{mode}")
            bwd = getattr(lib, f"lstm_stacked_backward_{mode}")
            fwd.argtypes = [_P] * 12 + [_I] * 4 + [_P]
            bwd.argtypes = [_P] * 18 + [_I] * 4 + [_P]
            fwd.restype = bwd.restype = ctypes.c_int
        lib.lstm_stacked_resident_clusters.argtypes = [_I] * 4
        lib.lstm_stacked_resident_clusters.restype = ctypes.c_int
        lib._typed = True
    return lib


def _aligned16(tensors):
    """The tensors, each copied if it does not start on 16 bytes (the
    layer route's GEMMs and reductions read them 16 bytes at a time)."""
    return [a if a is None or a.data_ptr() % 16 == 0 else a.clone()
            for a in tensors]


def _layers_lib():
    """K8's library, which holds the layer route's entry points."""
    lib = k8._lib()
    if not getattr(lib, "_layers_typed", False):
        lib.lstm_stacked_layers_workspace_floats.argtypes = [_I] * 4
        lib.lstm_stacked_layers_workspace_floats.restype = ctypes.c_longlong
        for mode in ("f32", "bf16"):
            fwd = getattr(lib, f"lstm_stacked_layers_forward_{mode}")
            bwd = getattr(lib, f"lstm_stacked_layers_backward_{mode}")
            fwd.argtypes = [_P] * 14 + [_I] * 6 + [_P]
            bwd.argtypes = [_P] * 19 + [_I] * 6 + [_P]
            fwd.restype = bwd.restype = ctypes.c_int
        lib._layers_typed = True
    return lib


def smem_bytes(layers: int, backward: bool, rows: int,
               bf16: bool = False) -> int:
    """Shared memory of one CTA of the forward or backward at ``rows``
    batch rows per cluster, of the f32 or the bf16 mode."""
    return _lib().lstm_stacked_smem_bytes(layers, int(backward), rows,
                                          int(bf16))


def resident_clusters(layers: int, backward: bool, rows: int = 16,
                      bf16: bool = False) -> int:
    """How many 8-CTA clusters of ``rows`` batch rows of the forward or
    backward kernel (f32 or bf16 mode) the current card holds at once
    (CUDA only); a larger batch runs in waves."""
    n = _lib().lstm_stacked_resident_clusters(layers, int(backward), rows,
                                              int(bf16))
    if n < 0:
        raise RuntimeError(
            f"no occupancy for {layers} layers at {rows} rows per cluster")
    return n


@functools.lru_cache(maxsize=None)
def layout(device_index: int, layers: int, backward: bool,
           bf16: bool = False):
    """(resident clusters, shared memory) by rows of the forward or
    backward of one mode on one card (``cluster_rows.card_layout``)."""
    with torch.cuda.device(device_index):
        return card_layout(
            lambda r: smem_bytes(layers, backward, r, bf16),
            lambda r: resident_clusters(layers, backward, r, bf16))


def _rows(name, device, layers, backward, batch, rows, bf16=False):
    return resolve_rows(name, batch, rows,
                        layout(device.index or 0, layers, backward, bf16))


def rows_for(device, layers: int, backward: bool, batch: int,
             bf16: bool = False) -> int:
    """The rows per cluster the wrapper launches at this batch."""
    return _rows("lstm_stacked", device, layers, backward, batch, None,
                 bf16)


def route(layers: int, hidden: int) -> Optional[str]:
    """The CUDA route of a stack: "wavefront" (``csrc/lstm_stacked.cu``),
    "layers" (K8's chains in layer-lagged windows), or None; by the hidden
    size the kernels run, ``padded_hidden(hidden)`` (H 65 to 127 at 2 or 3
    layers run padded to 128 on the wavefront)."""
    if padded_hidden(hidden) == HIDDEN and 2 <= layers <= MAX_LAYERS:
        return "wavefront"
    if padded_hidden(hidden) is not None and layers >= 2:
        return "layers"
    return None


def layers_chunk(t: int) -> int:
    """Steps a window of the layer route: 128 past 1,024 steps, else 64
    (capped at T). A window costs a launch and a GEMM a layer, and the
    schedule lags a window a layer: at H256 x L2 a training forward and
    backward read 17.8 ms at T2016 over C 128, 18.5 over 64 and 17.9
    over 256; 2.71 ms at T252 over 64, 2.89 over 32 and 2.96 over 128
    (``tools/k9_layer_route_sweep.py``; PERF.md section 6)."""
    return min(t, 128 if t > 1024 else 64)


def kernel_refusal(layers: int, hidden: int, batch: int):
    """Why ``lstm_stacked_recurrence`` cannot take this stack on CUDA, or
    None if it can."""
    if padded_hidden(hidden) is None:
        return (f"hidden size {hidden}: the K9 kernels take hidden sizes 1 "
                f"to {HIDDEN_SIZES[-1]} (the wavefront {HIDDEN} at 2 to "
                f"{MAX_LAYERS} layers, whose weights fit one 8-CTA cluster; "
                "the layer route the hidden sizes of the K8 chains it runs, "
                f"built for {HIDDEN_SIZES}, the others padded with zero "
                "units to the next)")
    if layers < 2:
        return f"{layers} layers: a stack has 2 or more"
    if batch < 1:
        return f"batch {batch}"
    return None


def _check(name, t, w_ih_t, b_rest, w_hh_t, h0, c0, **more):
    """Raise unless the kernels take these tensors: contiguous, on one
    CUDA device, f32 but for the weights (f32, or bf16 in the bf16 mode),
    shapes from h0 (L, B, H) and ``t``; ``more`` maps each further tensor
    to its expected shape. Returns (L, B, T, H, bf16 mode)."""
    if h0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {h0.device}")
    mm = w_hh_t.dtype
    if mm not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} (K9) takes f32 or bf16 weights; got {mm}")
    layers, b, h = h0.shape
    want = dict(w_ih_t=(w_ih_t, (layers - 1, h, 4 * h)),
                b_rest=(b_rest, (layers - 1, 4 * h)),
                w_hh_t=(w_hh_t, (layers, h, 4 * h)),
                h0=(h0, (layers, b, h)), c0=(c0, (layers, b, h)))
    want.update({k: (v, tuple(s(layers, b, t, h)))
                 for k, (v, s) in more.items()})
    for key, (a, shape) in want.items():
        dtype = mm if key in ("w_ih_t", "w_hh_t") else torch.float32
        if a.device != h0.device or a.dtype != dtype:
            raise ValueError(
                f"{name} kernel takes {dtype} {key} on one CUDA device "
                f"(weights f32, or bf16 in the bf16 mode; the rest f32); "
                f"got {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"{name}: expected {key} contiguous {shape}, got "
                f"{tuple(a.shape)} (contiguous={a.is_contiguous()})")
    why = (kernel_refusal(layers, h, b)
           or unbuilt(h, "K9", "lstm_stacked_recurrence") if t >= 1
           else f"T {t}")
    if why is not None:
        raise ValueError(f"{name}: no kernel for {why}")
    return layers, b, t, h, mm == torch.bfloat16


def _route_options(name, layered, layers, h, t, rows, chunk):
    """The layer route takes a window length and no rows per cluster, the
    wavefront the reverse; returns the layer route's window (or None)."""
    if layered and rows is not None:
        raise ValueError(f"{name}: the layer route (H {h}, {layers} layers) "
                         "takes no rows per cluster")
    if not layered:
        if chunk is not None:
            raise ValueError(f"{name}: the wavefront (H {h}, {layers} "
                             "layers) takes no window length")
        return None
    chunk = layers_chunk(t) if chunk is None else chunk
    if not 1 <= chunk <= t:
        raise ValueError(f"{name}: window of {chunk} steps over T {t}")
    return chunk


def lstm_stacked_forward(args, residuals: bool, rows: Optional[int] = None,
                         chunk: Optional[int] = None):
    """The forward kernels (CUDA only) of the stack's route: the wavefront
    at ``rows`` batch rows per cluster, or the layer route in windows of
    ``chunk`` steps (None: the wrapper's choice). Returns (ys, hn, cn, hs,
    acts, cs); hs (L-1, B, T, H), acts (L, B, T, 4H) and cs (L, B, T, H)
    are the backward's residuals, None unless ``residuals``."""
    xw0 = args[0]
    layers, b, t, h, bf16 = _check(
        "lstm_stacked_forward", xw0.shape[1], *args[1:],
        xw0=(xw0, lambda l, b, t, h: (b, t, 4 * h)))
    layered = route(layers, h) == "layers"
    chunk = _route_options("lstm_stacked_forward", layered, layers, h, t,
                           rows, chunk)
    if not layered:
        rows = _rows("lstm_stacked_forward", xw0.device, layers, False, b,
                     rows, bf16)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32,
                                     device=xw0.device)
    ys, hn, cn = new(b, t, h), new(layers, b, h), new(layers, b, h)
    hs = acts = cs = None
    if residuals:
        hs = new(layers - 1, b, t, h)
        acts = new(layers, b, t, 4 * h)
        cs = new(layers, b, t, h)
    global fwd_launches, bf16_fwd_launches
    global layers_fwd_launches, layers_bf16_fwd_launches
    if layered:
        lib = _layers_lib()
        fn = (lib.lstm_stacked_layers_forward_bf16 if bf16
              else lib.lstm_stacked_layers_forward_f32)
        ws = new(lib.lstm_stacked_layers_workspace_floats(b, h, layers, 0))
        _build.launch(fn, *_aligned16(args), ys, hn, cn, hs, acts, cs,
                      new(b, t, 4 * h), ws,
                      dims=(b, t, h, layers,
                            k8.launch_ctas(xw0.device, b, h, bf16), chunk))
        if bf16:
            layers_bf16_fwd_launches += 1
        else:
            layers_fwd_launches += 1
        return ys, hn, cn, hs, acts, cs
    lib = _lib()
    fn = (lib.lstm_stacked_forward_bf16 if bf16
          else lib.lstm_stacked_forward_f32)
    _build.launch(fn, *args, ys, hn, cn, hs, acts, cs,
                  dims=(b, t, layers, rows))
    if bf16:
        bf16_fwd_launches += 1
    else:
        fwd_launches += 1
    return ys, hn, cn, hs, acts, cs


def lstm_stacked_backward(weights, ys, hs, acts, cs, dys, dhn, dcn,
                          rows: Optional[int] = None,
                          chunk: Optional[int] = None):
    """The backward kernels (CUDA only) of the stack's route, from
    ``weights`` = (w_ih_t, b_rest, w_hh_t, h0, c0) and the forward's
    residuals: the wavefront at ``rows`` batch rows per cluster, or the
    layer route in windows of ``chunk`` steps (None: the wrapper's
    choice). Returns (dxw0, dw_ih_t, db_rest, dw_hh_t, dh0, dc0), each in
    its input's dtype."""
    w_ih_t, b_rest, w_hh_t, h0, c0 = weights
    cots = [c.float().contiguous() for c in (dys, dhn, dcn)]
    layers, b, t, h, bf16 = _check(
        "lstm_stacked_backward", ys.shape[1], *weights,
        ys=(ys, lambda l, b, t, h: (b, t, h)),
        hs=(hs, lambda l, b, t, h: (l - 1, b, t, h)),
        acts=(acts, lambda l, b, t, h: (l, b, t, 4 * h)),
        cs=(cs, lambda l, b, t, h: (l, b, t, h)),
        dys=(cots[0], lambda l, b, t, h: (b, t, h)),
        dhn=(cots[1], lambda l, b, t, h: (l, b, h)),
        dcn=(cots[2], lambda l, b, t, h: (l, b, h)))
    dgates = torch.empty(layers, b, t, 4 * h, dtype=torch.float32,
                         device=h0.device)
    dwih, db, dwhh, dh0, dc0 = [torch.empty_like(a) for a in weights]
    global bwd_launches, bf16_bwd_launches
    global layers_bwd_launches, layers_bf16_bwd_launches
    layered = route(layers, h) == "layers"
    chunk = _route_options("lstm_stacked_backward", layered, layers, h, t,
                           rows, chunk)
    if layered:
        lib = _layers_lib()
        ws = torch.empty(
            lib.lstm_stacked_layers_workspace_floats(b, h, layers, 1),
            dtype=torch.float32, device=h0.device)
        dy = torch.empty(b, t, h, dtype=torch.float32, device=h0.device)
        fn = (lib.lstm_stacked_layers_backward_bf16 if bf16
              else lib.lstm_stacked_layers_backward_f32)
        _build.launch(fn, *_aligned16((w_ih_t, w_hh_t, h0, c0, ys, hs, acts,
                                       cs, *cots)),
                      dgates, dwih, db, dwhh, dh0, dc0, dy, ws,
                      dims=(b, t, h, layers,
                            k8.launch_ctas(h0.device, b, h, bf16), chunk))
        if bf16:
            layers_bf16_bwd_launches += 1
        else:
            layers_bwd_launches += 1
        return dgates[0], dwih, db, dwhh, dh0, dc0
    rows = _rows("lstm_stacked_backward", h0.device, layers, True, b, rows,
                 bf16)
    lib = _lib()
    ws = torch.empty(lib.lstm_stacked_backward_workspace_floats(),
                     dtype=torch.float32, device=h0.device)
    fn = (lib.lstm_stacked_backward_bf16 if bf16
          else lib.lstm_stacked_backward_f32)
    _build.launch(fn, w_ih_t, w_hh_t, h0, c0, ys, hs, acts, cs, *cots,
                  dgates, dwih, db, dwhh, dh0, dc0, ws,
                  dims=(b, t, layers, rows))
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return dgates[0], dwih, db, dwhh, dh0, dc0


class _LstmStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ys, hn, cn, hs, acts, cs = lstm_stacked_forward(args, residuals=True)
        # xw0 itself is not needed again: only its shape (that of the
        # dgates) and the weights
        ctx.save_for_backward(*args[1:], ys, hs, acts, cs)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        *weights, ys, hs, acts, cs = ctx.saved_tensors
        cots = lstm_bf16.zero_none((dys, dhn, dcn),
                                   (ys, weights[3], weights[4]))
        return lstm_stacked_backward(weights, ys, hs, acts, cs, *cots)


def pad_args(args, hp: int):
    """(xw0, w_ih_t, b_rest, w_hh_t, h0, c0) of hidden size H as hidden
    size ``hp`` >= H: each gate block of xw0, b_rest and both weights'
    columns, the weights' rows, h0 and c0 padded with zero units
    (``ops/hidden_pad.py``; differentiable)."""
    xw0, w_ih_t, b_rest, w_hh_t, h0, c0 = args
    return (pad_gates(xw0, 4, hp), pad_weight(w_ih_t, 4, hp),
            pad_gates(b_rest, 4, hp), pad_weight(w_hh_t, 4, hp),
            pad_units(h0, hp), pad_units(c0, hp))


def unpad_outputs(ys, hn, cn, h: int):
    """(ys, h_n, c_n) of a padded run cut to the first ``h`` units."""
    return tuple(unpad_units(x, h) for x in (ys, hn, cn))


def lstm_stacked_recurrence(
    xw0: torch.Tensor,     # (B, T, 4H) f32
    w_ih_t: torch.Tensor,  # (L-1, H, 4H) f32, or bf16 in the bf16 mode
    b_rest: torch.Tensor,  # (L-1, 4H) f32
    w_hh_t: torch.Tensor,  # (L, H, 4H), w_ih_t's dtype
    h0: torch.Tensor, c0: torch.Tensor,  # (L, B, H) f32
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The stacked LSTM, differentiable; the weights' dtype picks the
    operand mode. CPU tensors take the plain version, CUDA tensors the
    kernels: a hidden size they are not built for on its arguments padded
    to ``padded_hidden`` (``pad_args``; the layer route), the outputs cut
    back (``unpad_outputs``); above 256 it raises, naming K9."""
    args = (xw0, w_ih_t, b_rest, w_hh_t, h0, c0)
    if xw0.device.type == "cpu":
        return lstm_stacked_reference(*args)
    h = h0.shape[-1]
    hp = padded_hidden(h) or h
    if hp != h and xw0.shape[-1] == 4 * h:
        args = pad_args(args, hp)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        ys, hn, cn = _LstmStacked.apply(*args)
    else:
        ys, hn, cn, _, _, _ = lstm_stacked_forward(args, residuals=False)
    ys, hn, cn = unpad_outputs(ys, hn, cn, h)
    return ys, (hn, cn)
