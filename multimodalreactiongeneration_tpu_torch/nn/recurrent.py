"""LSTM and GRU with torch-layout parameters.

Counterpart of ``TorchLSTM`` and ``TorchGRU`` in
``multimodalreactiongeneration_tpu/nn/recurrent.py``.

``TorchLSTM``: gate order i, f, g, o; bias b_ih + b_hh; parameters
``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``
and, when bidirectional, the same with ``_reverse``; states (L * D, B,
H), layer-major (``l0``, ``l0_reverse``, ``l1`` ...), as torch's. The
reverse direction runs on the time-flipped input and its outputs are
flipped back; the directions' outputs are concatenated on features.
Dispatch, as the JAX package's (``resolve_impl`` and the branches of
``TorchLSTM``):

  * under ``MIN_KERNEL_STEPS`` steps (the AR-decode steps, the 15-frame
    contexts of simple_lstm): the plain recurrence, layer by layer, on
    every device;
  * several layers, unidirectional, dropout 0 or eval mode (the JAX
    package's ``dropout == 0 or deterministic``):
    ``ops/lstm_stacked.py lstm_stacked_recurrence`` (K9 on CUDA: the
    one-cluster wavefront at hidden 128 and 2-3 layers, the layer route on
    K8's chains otherwise; the plain version on CPU) over x @ W_ih_0^T + b
    computed here; on CUDA, stacks the kernels do not take raise;
  * otherwise each layer and direction on its own (``single_layer_route``):
    with ``MRGEN_FUSED_DW`` on (the default; read at call time, as the JAX
    package's ``_fused_dw_enabled``) and input and hidden sizes multiples
    of 128, ``ops/lstm_layer.py lstm_layer`` (K7); else x @ W_ih^T + b as
    one matmul, then ``ops/lstm_recurrence.py lstm_recurrence`` (K8); on
    CUDA a hidden size K8 does not take raises; in training, dropout
    acts on each layer's output but the last's (``nn.basic.dropout``).

The operand dtype is the weights' (``weight_hh_l0``), as JAX's
``mm_dtype``: bf16 parameters (the bf16 training step) run the kernels'
bf16 operand mode with f32 state, biases and input products, and the
outputs and states come back in x's dtype; the input products and bias
sums round where JAX's do (K9's xw0 and K8's xw add b_ih and b_hh to the
f32 product of the converted operands one by one; K9's b_rest and K7's
b_sum are b_ih + b_hh summed in the weights' dtype). Under
``MIN_KERNEL_STEPS`` steps a bf16 LSTM runs JAX's ``_lstm_scan`` in bf16
(``lstm_scan_lowp``: bf16 carries, unlike the kernels' f32 state).

``TorchGRU``: gate order r, z, n with b_hn inside the reset product;
parameters ``weight_ih_l{k}`` (3H, din), ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}``; states h (L, B, H). Layer by layer,
under ``MIN_KERNEL_STEPS`` steps the plain recurrence on every device;
from there on x @ W_ih^T + b_ih as one matmul, then ``ops/gru.py
gru_recurrence`` (the K10 kernels on CUDA, the plain version on CPU); on
CUDA, a hidden size the kernels do not take raises. Bidirectional, as
the LSTM: the reverse direction (``_reverse`` parameters) runs on the
time-flipped input, its outputs are flipped back and concatenated on
features, states (L * D, B, H) layer-major. In training, dropout acts
between layers, as the LSTM's. The dtypes flow as JAX's (``TorchGRU`` of ``nn/recurrent.py`` there): on the
kernel route xw is the f32 product of x and W_ih converted (exact) plus
b_ih in f32, W_hh^T goes in the weights' dtype (bf16: the kernels' bf16
mode), b_hh and h0 in f32, ys and h_n come back in x's dtype; under
``MIN_KERNEL_STEPS`` steps bf16 weights run JAX's ``_gru_scan``
(``gru_scan_lowp``: the step in x's dtype, h carried rounded).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.basic import dropout
from multimodalreactiongeneration_tpu_torch.ops import gru as gru_ops
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as k7
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as k8
from multimodalreactiongeneration_tpu_torch.ops.lstm_layer import (
    lstm_layer,
    lstm_layer_reference,
)
from multimodalreactiongeneration_tpu_torch.ops.lstm_stacked import (
    kernel_refusal,
    lstm_stacked_recurrence,
)

LSTMState = Tuple[torch.Tensor, torch.Tensor]

# under 16 steps a kernel's set-up costs more than it saves
MIN_KERNEL_STEPS = 16


def fused_dw_enabled() -> bool:
    """``MRGEN_FUSED_DW`` as the JAX package reads it
    (``ops/pallas_lstm_stacked.py _fused_dw_enabled``): on unless "0"."""
    return os.environ.get("MRGEN_FUSED_DW", "1") != "0"


def single_layer_route(device_type: str, steps: int, din: int,
                       hidden: int) -> str:
    """The JAX package's route for one layer and direction of an LSTM:
    "plain" under ``MIN_KERNEL_STEPS`` steps, "lstm_layer" (K7) with
    ``MRGEN_FUSED_DW`` on and 128-aligned sizes, else "lstm_recurrence"
    (K8); on CUDA, raises for a size the route's kernels do not take."""
    if steps < MIN_KERNEL_STEPS:
        return "plain"
    if fused_dw_enabled() and din % 128 == 0 and hidden % 128 == 0:
        why = k7.kernel_refusal(hidden, din)
        if why is not None and device_type == "cuda":
            raise NotImplementedError(
                f"an LSTM of input {din} over {steps} steps needs the "
                f"lstm_layer kernels (K7), which do not take {why}")
        return "lstm_layer"
    why = k8.kernel_refusal(hidden)
    if why is not None and device_type == "cuda":
        raise NotImplementedError(
            f"an LSTM of input {din} over {steps} steps needs the "
            f"lstm_recurrence kernels (K8), which do not take {why}")
    return "lstm_recurrence"


def use_lstm_stacked(device_type: str, steps: int, layers: int, hidden: int,
                     batch: int) -> bool:
    """True where the JAX package runs ``lstm_stacked_recurrence`` on a
    unidirectional stack without active dropout; on CUDA, raises for a
    stack the kernels do not take."""
    if steps < MIN_KERNEL_STEPS or layers < 2:
        return False
    why = kernel_refusal(layers, hidden, batch)
    if why is not None and device_type == "cuda":
        raise NotImplementedError(
            f"a {layers}-layer LSTM over {steps} steps needs the stacked "
            f"LSTM kernels (K9), which do not take {why}")
    return True


def use_gru_kernel(device_type: str, steps: int, hidden: int) -> bool:
    """True where the JAX package runs ``gru_recurrence``; on CUDA, raises
    for a hidden size the kernels do not take."""
    if steps < MIN_KERNEL_STEPS:
        return False
    why = gru_ops.kernel_refusal(hidden)
    if why is not None and device_type == "cuda":
        raise NotImplementedError(
            f"a GRU over {steps} steps needs the GRU recurrence kernels "
            f"(K10), which do not take {why}")
    return True


def _uniform_params(module, generator, bound, gates, input_size,
                    hidden_size, num_layers, directions=1):
    """torch's RNN parameters, uniform(+-bound) from ``generator``."""
    def uniform(*shape):
        w = torch.empty(*shape)
        w.uniform_(-bound, bound, generator=generator)
        return nn.Parameter(w)

    for k in range(num_layers):
        din = input_size if k == 0 else hidden_size * directions
        for d in range(directions):
            sfx = f"l{k}" + ("_reverse" if d else "")
            setattr(module, f"weight_ih_{sfx}",
                    uniform(gates * hidden_size, din))
            setattr(module, f"weight_hh_{sfx}",
                    uniform(gates * hidden_size, hidden_size))
            setattr(module, f"bias_ih_{sfx}", uniform(gates * hidden_size))
            setattr(module, f"bias_hh_{sfx}", uniform(gates * hidden_size))


def gru_scan_lowp(x, w_ih_t, b_ih, b_hh, w_hh_t, h0):
    """JAX's ``_gru_scan`` in x's dtype: the input product in f32 plus
    b_ih, rounded to x's dtype; each step's h W_hh + b_hh in f32, rounded,
    and the gates in x's dtype, so h is carried rounded. Returns (ys, h)
    in x's dtype."""
    dtype = x.dtype
    xw = (x.float() @ w_ih_t.float() + b_ih.float()).to(dtype)
    w = w_hh_t.float()
    h = h0.to(dtype)
    ys = []
    for t in range(x.shape[1]):
        hr, hz, hn = (h.float() @ w + b_hh.float()).to(dtype).chunk(3, -1)
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1), h


def lstm_scan_lowp(x, w_ih_t, b_ih, b_hh, w_hh_t, h0, c0):
    """JAX's ``_lstm_scan`` in x's dtype (bf16): the input product in f32
    plus both biases, rounded to x's dtype; each step adds h W_hh (f32
    sums, rounded) and runs the cell in x's dtype, so h and c are carried
    rounded. Returns (ys, (hn, cn)) in x's dtype."""
    dtype = x.dtype
    xw = (x.float() @ w_ih_t.float() + b_ih.float() + b_hh.float()).to(dtype)
    w = w_hh_t.float()
    h, c = h0.to(dtype), c0.to(dtype)
    ys = []
    for t in range(x.shape[1]):
        gates = xw[:, t] + (h.float() @ w).to(dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


class TorchLSTM(nn.Module):
    """torch.nn.LSTM(batch_first=True) equivalent with uniform(+-1/sqrt(H))
    init drawn from an explicit generator.

    State convention as torch: ``hx`` is (h, c), each (L * D, B, H) with D
    the directions; None means zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        self.dropout = dropout
        _uniform_params(self, generator, 1.0 / math.sqrt(hidden_size), 4,
                        input_size, hidden_size, num_layers, self.directions)

    def _params(self, k: int, reverse: bool = False):
        """(W_ih^T, b_ih, b_hh, W_hh^T) of layer k, one direction."""
        sfx = f"l{k}" + ("_reverse" if reverse else "")
        return (getattr(self, f"weight_ih_{sfx}").T,
                getattr(self, f"bias_ih_{sfx}"),
                getattr(self, f"bias_hh_{sfx}"),
                getattr(self, f"weight_hh_{sfx}").T)

    def _layer(self, k: int, reverse: bool = False):
        """(W_ih^T, b_ih + b_hh, W_hh^T) of layer k, one direction."""
        w_ih_t, b_ih, b_hh, w_hh_t = self._params(k, reverse)
        return w_ih_t, b_ih + b_hh, w_hh_t

    def _direction(self, x, args, h0, c0):
        """One layer in one direction over x (B, T, din), by
        ``single_layer_route``; outputs and states in x's dtype."""
        w_ih_t, b_ih, b_hh, w_hh_t = args
        mm = w_hh_t.dtype
        bf16 = mm == torch.bfloat16
        route = single_layer_route(x.device.type, x.shape[1], x.shape[-1],
                                   self.hidden_size)
        f32 = lambda a: a.float().contiguous()
        if route == "lstm_layer":
            ys, (h, c) = lstm_layer(
                x.to(mm).contiguous(), w_ih_t.to(mm).contiguous(),
                f32(b_ih + b_hh), w_hh_t.to(mm).contiguous(), f32(h0),
                f32(c0))
            return ys.to(x.dtype), (h.to(x.dtype), c.to(x.dtype))
        if route == "lstm_recurrence":
            if bf16:  # JAX: the f32 einsum, + b_ih + b_hh one by one
                xw = x.float() @ w_ih_t.float() + b_ih.float() + b_hh.float()
            else:
                xw = x @ w_ih_t + (b_ih + b_hh)
            ys, (h, c) = k8.lstm_recurrence(
                f32(xw), w_hh_t.contiguous(), f32(h0), f32(c0))
            return ys.to(x.dtype), (h.to(x.dtype), c.to(x.dtype))
        if bf16:
            return lstm_scan_lowp(x, w_ih_t, b_ih, b_hh, w_hh_t, h0, c0)
        return lstm_layer_reference(x, w_ih_t, b_ih + b_hh, w_hh_t, h0, c0)

    def forward(
        self, x: torch.Tensor, hx: Optional[LSTMState] = None
    ) -> Tuple[torch.Tensor, LSTMState]:
        layers, steps, dirs = self.num_layers, x.shape[1], self.directions
        if hx is None:
            zeros = x.new_zeros(layers * dirs, x.shape[0], self.hidden_size)
            hx = (zeros, zeros)
        # the stacked kernels' backward (K9) serves both MRGEN_FUSED_DW
        # settings: the JAX package's _bwd_kernel and _bwd_kernel_fused
        # (ops/pallas_lstm_stacked.py:230, :317) compute the same function;
        # active dropout between layers takes the stack layer by layer
        inactive = self.dropout == 0 or not self.training
        if dirs == 1 and inactive and use_lstm_stacked(
                x.device.type, steps, layers, self.hidden_size, x.shape[0]):
            w_ih0, b_ih0, b_hh0, w_hh0 = self._params(0)
            rest = [self._params(k) for k in range(1, layers)]
            mm = w_hh0.dtype
            if mm == torch.bfloat16:
                # JAX: the f32 product of the bf16 operands, + b_ih + b_hh
                xw0 = x.float() @ w_ih0.float() + b_ih0.float() + b_hh0.float()
            else:
                xw0 = x @ w_ih0 + (b_ih0 + b_hh0)
            ys, (hn, cn) = lstm_stacked_recurrence(
                xw0.float().contiguous(),
                torch.stack([r[0] for r in rest]).to(mm).contiguous(),
                torch.stack([r[1] + r[2] for r in rest]).float().contiguous(),
                torch.stack([w_hh0] + [r[3] for r in rest]).to(mm)
                .contiguous(),
                hx[0].float().contiguous(), hx[1].float().contiguous(),
            )
            return ys.to(x.dtype), (hn.to(x.dtype), cn.to(x.dtype))
        hs, cs = [], []
        for k in range(layers):
            outs = []
            for d in range(dirs):
                idx = k * dirs + d
                # the reverse direction reads the sequence back to front;
                # its h_n is the state after the first original frame
                x_dir = torch.flip(x, [1]) if d else x
                ys, (h, c) = self._direction(x_dir, self._params(k, d == 1),
                                             hx[0][idx], hx[1][idx])
                outs.append(torch.flip(ys, [1]) if d else ys)
                hs.append(h)
                cs.append(c)
            x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
            if k < layers - 1:
                x = dropout(x, self.dropout, self.training)
        return x, (torch.stack(hs), torch.stack(cs))


class TorchGRU(nn.Module):
    """torch.nn.GRU(batch_first=True) equivalent with uniform(+-1/sqrt(H))
    init drawn from an explicit generator.

    State convention as torch: ``hx`` is h (L * D, B, H) with D the
    directions; None means zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = 2 if bidirectional else 1
        self.dropout = dropout
        _uniform_params(self, generator, 1.0 / math.sqrt(hidden_size), 3,
                        input_size, hidden_size, num_layers, self.directions)

    def _direction(self, x, k: int, reverse: bool, h0, kernel: bool):
        """Layer k in one direction over x (B, T, din): (ys, h_n) in x's
        dtype."""
        sfx = f"l{k}" + ("_reverse" if reverse else "")
        w_ih = getattr(self, f"weight_ih_{sfx}")
        b_ih = getattr(self, f"bias_ih_{sfx}")
        w_hh = getattr(self, f"weight_hh_{sfx}")
        b_hh = getattr(self, f"bias_hh_{sfx}")
        if kernel:
            # the input projection for the whole sequence, outside the
            # recurrence: JAX's einsum (preferred f32) + b_ih
            xw = x.float() @ w_ih.T.float() + b_ih.float()
            ys, h = gru_ops.gru_recurrence(
                xw.contiguous(), w_hh.T.contiguous(),
                b_hh.float().contiguous(), h0.float().contiguous())
            return ys.to(x.dtype), h.to(x.dtype)
        if w_hh.dtype == torch.bfloat16:
            return gru_scan_lowp(x, w_ih.T, b_ih, b_hh, w_hh.T, h0)
        return gru_ops.gru_recurrence_reference(x @ w_ih.T + b_ih, w_hh.T,
                                                b_hh, h0)

    def forward(
        self, x: torch.Tensor, hx: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        layers, steps, dirs = self.num_layers, x.shape[1], self.directions
        if hx is None:
            hx = x.new_zeros(layers * dirs, x.shape[0], self.hidden_size)
        kernel = use_gru_kernel(x.device.type, steps, self.hidden_size)
        hs = []
        for k in range(layers):
            outs = []
            for d in range(dirs):
                # the reverse direction reads the sequence back to front
                # (JAX's jnp.flip on its kernel route); its h_n is the
                # state after the first original frame
                x_dir = torch.flip(x, [1]) if d else x
                ys, h = self._direction(x_dir, k, d == 1, hx[k * dirs + d],
                                        kernel)
                outs.append(torch.flip(ys, [1]) if d else ys)
                hs.append(h)
            x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
            if k < layers - 1:
                x = dropout(x, self.dropout, self.training)
        return x, torch.stack(hs)
