"""LSTM and GRU with torch-layout parameters.

Counterpart of ``TorchLSTM`` and ``TorchGRU`` in
``multimodalreactiongeneration_tpu/nn/recurrent.py``.

``TorchLSTM``: gate order i, f, g, o; bias b_ih + b_hh; parameters
``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``
and states (L, B, H), as torch's. Dispatch, as the JAX package's
(``resolve_impl`` and the branches of ``TorchLSTM``):

  * under ``MIN_KERNEL_STEPS`` steps (the AR-decode steps): the plain
    recurrence, layer by layer, on every device;
  * several layers, unidirectional, dropout 0 or eval mode:
    ``ops/lstm_stacked.py lstm_stacked_recurrence`` (the wavefront kernels
    on CUDA, the plain version on CPU) over x @ W_ih_0^T + b computed
    here; on CUDA, stacks the kernels do not take raise;
  * one layer with input and hidden sizes multiples of 128:
    ``ops/lstm_layer.py lstm_layer``; other sizes: the plain recurrence on
    CPU; on CUDA they need the ``lstm_recurrence`` kernels, which are not
    ported yet, so they raise;
  * dropout between layers in training raises (not ported yet), and so
    does a bidirectional LSTM (it comes with simple_lstm's slice).

``TorchGRU``: gate order r, z, n with b_hn inside the reset product;
parameters ``weight_ih_l{k}`` (3H, din), ``weight_hh_l{k}``,
``bias_ih_l{k}``, ``bias_hh_l{k}``; states h (L, B, H). Layer by layer,
under ``MIN_KERNEL_STEPS`` steps the plain recurrence on every device;
from there on x @ W_ih^T + b_ih as one matmul, then ``ops/gru.py
gru_recurrence`` (the K10 kernels on CUDA, the plain version on CPU); on
CUDA, a hidden size the kernels do not take raises. Dropout between
layers in training and a bidirectional GRU raise, as for the LSTM.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.basic import refuse_dropout
from multimodalreactiongeneration_tpu_torch.ops import gru as gru_ops
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


def use_lstm_layer(device_type: str, steps: int, din: int,
                   hidden: int) -> bool:
    """True where the JAX package runs ``lstm_layer``; raises where it
    runs a kernel the port does not have yet."""
    if steps < MIN_KERNEL_STEPS:
        return False
    if din % 128 == 0 and hidden % 128 == 0:
        return True
    if device_type == "cuda":
        raise NotImplementedError(
            f"an LSTM of input {din}, hidden {hidden} over {steps} steps "
            "needs the lstm_recurrence kernels (K8, ops/pallas_lstm.py:702 "
            "of the JAX package), which are not ported yet"
        )
    return False


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
                    hidden_size, num_layers):
    """torch's RNN parameters, uniform(+-bound) from ``generator``."""
    def uniform(*shape):
        w = torch.empty(*shape)
        w.uniform_(-bound, bound, generator=generator)
        return nn.Parameter(w)

    for k in range(num_layers):
        din = input_size if k == 0 else hidden_size
        setattr(module, f"weight_ih_l{k}", uniform(gates * hidden_size, din))
        setattr(module, f"weight_hh_l{k}",
                uniform(gates * hidden_size, hidden_size))
        setattr(module, f"bias_ih_l{k}", uniform(gates * hidden_size))
        setattr(module, f"bias_hh_l{k}", uniform(gates * hidden_size))


class TorchLSTM(nn.Module):
    """torch.nn.LSTM(batch_first=True) equivalent with uniform(+-1/sqrt(H))
    init drawn from an explicit generator.

    State convention as torch: ``hx`` is (h, c), each (L, B, H); None
    means zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0):
        super().__init__()
        if bidirectional:
            raise NotImplementedError(
                "a bidirectional LSTM comes with simple_lstm's slice (ROADMAP "
                "queue B)")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        _uniform_params(self, generator, 1.0 / math.sqrt(hidden_size), 4,
                        input_size, hidden_size, num_layers)

    def _layer(self, k: int):
        """(W_ih^T, b_ih + b_hh, W_hh^T) of layer k."""
        return (getattr(self, f"weight_ih_l{k}").T,
                getattr(self, f"bias_ih_l{k}") + getattr(self, f"bias_hh_l{k}"),
                getattr(self, f"weight_hh_l{k}").T)

    def forward(
        self, x: torch.Tensor, hx: Optional[LSTMState] = None
    ) -> Tuple[torch.Tensor, LSTMState]:
        layers, steps = self.num_layers, x.shape[1]
        if hx is None:
            zeros = x.new_zeros(layers, x.shape[0], self.hidden_size)
            hx = (zeros, zeros)
        if layers > 1:  # dropout acts between layers
            refuse_dropout(self)
        if use_lstm_stacked(x.device.type, steps, layers, self.hidden_size,
                            x.shape[0]):
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
            args = self._layer(k)
            if use_lstm_layer(x.device.type, steps, x.shape[-1],
                              self.hidden_size):
                x, (h, c) = lstm_layer(
                    x.float().contiguous(), *[a.contiguous() for a in args],
                    hx[0][k].float().contiguous(),
                    hx[1][k].float().contiguous(),
                )
            else:
                x, (h, c) = lstm_layer_reference(x, *args, hx[0][k],
                                                 hx[1][k])
            hs.append(h)
            cs.append(c)
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
