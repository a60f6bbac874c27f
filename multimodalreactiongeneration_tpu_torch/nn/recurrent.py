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
  * several layers, unidirectional, dropout 0 or eval mode:
    ``ops/lstm_stacked.py lstm_stacked_recurrence`` (the wavefront kernels,
    K9, on CUDA, the plain version on CPU) over x @ W_ih_0^T + b computed
    here; on CUDA, stacks the kernels do not take raise;
  * otherwise each layer and direction on its own (``single_layer_route``):
    with ``MRGEN_FUSED_DW`` on (the default; read at call time, as the JAX
    package's ``_fused_dw_enabled``) and input and hidden sizes multiples
    of 128, ``ops/lstm_layer.py lstm_layer`` (K7); else x @ W_ih^T + b as
    one matmul, then ``ops/lstm_recurrence.py lstm_recurrence`` (K8); on
    CUDA a hidden size K8 does not take raises;
  * dropout between layers in training raises (not ported yet).

``TorchGRU``: gate order r, z, n with b_hn inside the reset product;
parameters ``weight_ih_l{k}`` (3H, din), ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}``; states h (L, B, H). Layer by layer,
under ``MIN_KERNEL_STEPS`` steps the plain recurrence on every device;
from there on x @ W_ih^T + b_ih as one matmul, then ``ops/gru.py
gru_recurrence`` (the K10 kernels on CUDA, the plain version on CPU); on
CUDA, a hidden size the kernels do not take raises. Dropout between
layers in training and a bidirectional GRU raise.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.basic import refuse_dropout
from multimodalreactiongeneration_tpu_torch.ops import gru as gru_ops
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
    (K8); on CUDA, raises for a hidden size K8 does not take."""
    if steps < MIN_KERNEL_STEPS:
        return "plain"
    if fused_dw_enabled() and din % 128 == 0 and hidden % 128 == 0:
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

    def _layer(self, k: int, reverse: bool = False):
        """(W_ih^T, b_ih + b_hh, W_hh^T) of layer k, one direction."""
        sfx = f"l{k}" + ("_reverse" if reverse else "")
        return (getattr(self, f"weight_ih_{sfx}").T,
                getattr(self, f"bias_ih_{sfx}") + getattr(self, f"bias_hh_{sfx}"),
                getattr(self, f"weight_hh_{sfx}").T)

    def _direction(self, x, args, h0, c0):
        """One layer in one direction over x (B, T, din), by
        ``single_layer_route``."""
        w_ih_t, b, w_hh_t = args
        route = single_layer_route(x.device.type, x.shape[1], x.shape[-1],
                                   self.hidden_size)
        if route == "lstm_layer":
            return lstm_layer(x.float().contiguous(),
                              *[a.float().contiguous() for a in args],
                              h0.float().contiguous(), c0.float().contiguous())
        if route == "lstm_recurrence":
            return k8.lstm_recurrence(
                (x @ w_ih_t + b).float().contiguous(),
                w_hh_t.float().contiguous(), h0.float().contiguous(),
                c0.float().contiguous())
        return lstm_layer_reference(x, *args, h0, c0)

    def forward(
        self, x: torch.Tensor, hx: Optional[LSTMState] = None
    ) -> Tuple[torch.Tensor, LSTMState]:
        layers, steps, dirs = self.num_layers, x.shape[1], self.directions
        if hx is None:
            zeros = x.new_zeros(layers * dirs, x.shape[0], self.hidden_size)
            hx = (zeros, zeros)
        if layers > 1:  # dropout acts between layers
            refuse_dropout(self)
        # the stacked kernels' backward (K9) serves both MRGEN_FUSED_DW
        # settings: the JAX package's _bwd_kernel and _bwd_kernel_fused
        # (ops/pallas_lstm_stacked.py:230, :317) compute the same function
        if dirs == 1 and use_lstm_stacked(x.device.type, steps, layers,
                                          self.hidden_size, x.shape[0]):
            w_ih0, b0, w_hh0 = self._layer(0)
            rest = [self._layer(k) for k in range(1, layers)]
            return lstm_stacked_recurrence(
                (x @ w_ih0 + b0).float().contiguous(),
                torch.stack([w for w, _, _ in rest]).float().contiguous(),
                torch.stack([b for _, b, _ in rest]).float().contiguous(),
                torch.stack([w_hh0] + [w for _, _, w in rest]).float()
                .contiguous(),
                hx[0].float().contiguous(), hx[1].float().contiguous(),
            )
        hs, cs = [], []
        for k in range(layers):
            outs = []
            for d in range(dirs):
                idx = k * dirs + d
                # the reverse direction reads the sequence back to front;
                # its h_n is the state after the first original frame
                x_dir = torch.flip(x, [1]) if d else x
                ys, (h, c) = self._direction(x_dir, self._layer(k, d == 1),
                                             hx[0][idx], hx[1][idx])
                outs.append(torch.flip(ys, [1]) if d else ys)
                hs.append(h)
                cs.append(c)
            x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        return x, (torch.stack(hs), torch.stack(cs))


class TorchGRU(nn.Module):
    """torch.nn.GRU(batch_first=True) equivalent with uniform(+-1/sqrt(H))
    init drawn from an explicit generator.

    State convention as torch: ``hx`` is h (L, B, H); None means zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        if bidirectional:
            raise NotImplementedError(
                "a bidirectional GRU is not ported (no shipped config "
                "runs one)")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        _uniform_params(self, generator, 1.0 / math.sqrt(hidden_size), 3,
                        input_size, hidden_size, num_layers)

    def forward(
        self, x: torch.Tensor, hx: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        layers, steps = self.num_layers, x.shape[1]
        if hx is None:
            hx = x.new_zeros(layers, x.shape[0], self.hidden_size)
        if layers > 1:  # dropout acts between layers
            refuse_dropout(self)
        kernel = use_gru_kernel(x.device.type, steps, self.hidden_size)
        hs = []
        for k in range(layers):
            w_hh = getattr(self, f"weight_hh_l{k}")
            b_hh = getattr(self, f"bias_hh_l{k}")
            # the input projection for the whole sequence, outside the
            # recurrence, as the JAX package computes it
            xw = (x @ getattr(self, f"weight_ih_l{k}").T
                  + getattr(self, f"bias_ih_l{k}"))
            if kernel:
                x, h = gru_ops.gru_recurrence(
                    xw.float().contiguous(), w_hh.T.float().contiguous(),
                    b_hh.float().contiguous(), hx[k].float().contiguous())
            else:
                x, h = gru_ops.gru_recurrence_reference(xw, w_hh.T, b_hh,
                                                        hx[k])
            hs.append(h)
        return x, torch.stack(hs)
