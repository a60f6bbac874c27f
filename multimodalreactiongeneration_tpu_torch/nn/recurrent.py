"""LSTM with torch-layout parameters.

Counterpart of ``TorchLSTM`` in ``multimodalreactiongeneration_tpu/
nn/recurrent.py``. Gate order i, f, g, o; bias b_ih + b_hh. Dispatch, as
the JAX package's (``resolve_impl`` and the ``lstm_layer`` gate of
``TorchLSTM``):

  * under ``MIN_KERNEL_STEPS`` steps (the AR-decode embeddings): the
    plain recurrence on every device;
  * from there on, with input and hidden sizes multiples of 128:
    ``ops/lstm_layer.py lstm_layer`` (the kernels on CUDA, the plain
    version on CPU);
  * other sizes: the plain recurrence on CPU; on CUDA they need the
    ``lstm_recurrence`` kernels, which are not ported yet, so they raise.

Only the single-layer unidirectional LSTM is ported (every LSTM of the
Metaformer is one). The stacked, bidirectional and GRU forms come with
the models that use them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.ops.lstm_layer import (
    lstm_layer,
    lstm_layer_reference,
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


class TorchLSTM(nn.Module):
    """torch.nn.LSTM(batch_first=True, num_layers=1) equivalent with
    uniform(+-1/sqrt(H)) init drawn from an explicit generator.

    State convention as torch: ``hx`` is (h, c), each (1, B, H); None
    means zeros."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_size = hidden_size
        bound = 1.0 / math.sqrt(hidden_size)

        def uniform(*shape):
            w = torch.empty(*shape)
            w.uniform_(-bound, bound, generator=generator)
            return nn.Parameter(w)

        self.weight_ih_l0 = uniform(4 * hidden_size, input_size)
        self.weight_hh_l0 = uniform(4 * hidden_size, hidden_size)
        self.bias_ih_l0 = uniform(4 * hidden_size)
        self.bias_hh_l0 = uniform(4 * hidden_size)

    def forward(
        self, x: torch.Tensor, hx: Optional[LSTMState] = None
    ) -> Tuple[torch.Tensor, LSTMState]:
        if hx is None:
            zeros = x.new_zeros(1, x.shape[0], self.hidden_size)
            hx = (zeros, zeros)
        args = (self.weight_ih_l0.T, self.bias_ih_l0 + self.bias_hh_l0,
                self.weight_hh_l0.T)
        if use_lstm_layer(x.device.type, x.shape[1], x.shape[-1],
                          self.hidden_size):
            ys, (h, c) = lstm_layer(
                x.float().contiguous(), *[a.contiguous() for a in args],
                hx[0][0].float().contiguous(), hx[1][0].float().contiguous(),
            )
        else:
            ys, (h, c) = lstm_layer_reference(x, *args, hx[0][0], hx[1][0])
        return ys, (h[None], c[None])
