"""LSTM with torch-layout parameters, as a plain recurrence.

Counterpart of ``TorchLSTM`` in ``multimodalreactiongeneration_tpu/
nn/recurrent.py`` on its scan path (``_lstm_scan``): the input
projection for the whole sequence is one matmul, only h @ W_hh^T runs
inside the time loop. Gate order i, f, g, o; bias b_ih + b_hh.

Only the single-layer unidirectional LSTM is ported (every LSTM of the
Metaformer decode path is one). The stacked, bidirectional and GRU
forms, and their kernel dispatch points, come with the models that use
them. Decode-sized sequences stay on this recurrence on every device,
as in the JAX package (``resolve_impl``: under 16 steps, the scan).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

LSTMState = Tuple[torch.Tensor, torch.Tensor]


def lstm_recurrence(
    x: torch.Tensor,
    h0: torch.Tensor,
    c0: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b_ih: torch.Tensor,
    b_hh: torch.Tensor,
) -> Tuple[torch.Tensor, LSTMState]:
    """(B, T, I) single-direction LSTM; returns (ys (B, T, H), (h, c))."""
    xw = x @ w_ih.T + b_ih + b_hh
    w_hh_t = w_hh.T
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        gates = xw[:, t] + h @ w_hh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


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
        ys, (h, c) = lstm_recurrence(
            x, hx[0][0], hx[1][0], self.weight_ih_l0, self.weight_hh_l0,
            self.bias_ih_l0, self.bias_hh_l0,
        )
        return ys, (h[None], c[None])
