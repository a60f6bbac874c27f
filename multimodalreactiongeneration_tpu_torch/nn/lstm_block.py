"""Layered-LSTM blocks and the LSTM sampler of lstm_with_sampling.

Counterpart of ``multimodalreactiongeneration_tpu/nn/lstm_block.py``; the
attribute names are the flax names, so a JAX parameter tree converts 1:1
(``models/weights.py``). Note the doubled name: ``LSTMBlock`` holds its
``LSTMModule`` as ``lstm_module``, whose LSTM is again ``lstm_module``
(``block_0.lstm_module.lstm_module.weight_ih_l0``).

  * ``LSTMModule``: TorchLSTM + an optional mixing Dense (``mixer``);
  * ``LSTMBlock``: LSTMModule (+ FFN), each optionally residual + LN;
  * ``LSTMLayerd``: a stack of blocks threading a list of (h, c) states;
    it returns the NEW states (the JAX package's PARITY deviation #1: the
    reference returns the input states);
  * ``LSTMSampler``: a unidirectional TorchLSTM keeping every
    ``decline_rate``-th hidden state (100 Hz audio -> 12.5 fps).

In training, ``LSTMBlock`` applies dropout after the LSTM's residual
(and LayerNorm) and after the FFN's, where the block is residual, as the
JAX package does; the stacked LSTMs apply theirs between layers
(``nn/recurrent.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.basic import (
    LayerNorm,
    dense,
    dropout,
)
from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
    LSTMState,
    TorchLSTM,
)

LayerStates = List[Optional[LSTMState]]


class LSTMModule(nn.Module):
    """TorchLSTM + optional mixing Dense (reference lstm_block.py:9-46)."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 output_size: int = 256, dropout: float = 0.0,
                 bidirectional: bool = True, use_mixing: bool = True):
        super().__init__()
        lstm_out = hidden_size * (2 if bidirectional else 1)
        if not use_mixing and lstm_out != output_size:
            raise ValueError(
                "lstm_out_size must equal output_size when use_mixing is False")
        self.lstm_module = TorchLSTM(input_size, hidden_size, generator,
                                     num_layers=num_layers,
                                     bidirectional=bidirectional,
                                     dropout=dropout)
        self.mixer = (dense(lstm_out, output_size, generator) if use_mixing
                      else None)

    def forward(self, x, hx=None):
        hs, hx = self.lstm_module(x, hx)
        if self.mixer is not None:
            hs = self.mixer(hs)
        return hs, hx


class LSTMBlock(nn.Module):
    """LSTMModule + optional FFN, both optionally residual+LN wrapped."""

    def __init__(self, input_size: int, hidden_size: int, lstm_out_size: int,
                 generator: torch.Generator, num_layers: int = 1,
                 bottleneck_size: int = 64, output_size: int = 256,
                 dropout: float = 0.0, bidirectional: bool = True,
                 use_layer_norm: bool = True, use_relu: bool = True,
                 use_mixing: bool = False, use_residual: bool = True,
                 use_feed_forward: bool = True):
        super().__init__()
        if use_residual and (input_size != lstm_out_size
                             or lstm_out_size != output_size):
            raise ValueError(
                "input_size must equal lstm_out_size and output_size when "
                "use_residual is set")
        self.dropout = dropout
        self.use_residual = use_residual
        self.use_relu = use_relu
        self.use_feed_forward = use_feed_forward
        self.lstm_module = LSTMModule(
            input_size, hidden_size, generator, num_layers=num_layers,
            output_size=lstm_out_size, dropout=dropout,
            bidirectional=bidirectional, use_mixing=use_mixing)
        norm = use_residual and use_layer_norm
        self.lstm_norm = LayerNorm(lstm_out_size) if norm else None
        if use_feed_forward:
            self.ff_input = dense(lstm_out_size, bottleneck_size, generator)
            self.ff_mapping = dense(bottleneck_size, output_size, generator)
            self.ff_norm = LayerNorm(output_size) if norm else None

    def forward(self, x, hx=None):
        y, hx = self.lstm_module(x, hx)
        if self.use_residual:
            y = y + x
            if self.lstm_norm is not None:
                y = self.lstm_norm(y)
            y = dropout(y, self.dropout, self.training)
        if self.use_feed_forward:
            f = self.ff_input(y)
            if self.use_relu:
                f = torch.relu(f)
            f = self.ff_mapping(f)
            if self.use_residual:
                f = f + y
                if self.ff_norm is not None:
                    f = self.ff_norm(f)
                f = dropout(f, self.dropout, self.training)
            y = f
        return y, hx


class LSTMLayerd(nn.Module):
    """Stack of LSTMBlocks with a per-block state list (reference
    :110-169), returning the new states."""

    def __init__(self, input_size: int, lstm_hidden_size: int,
                 generator: torch.Generator, affine_hidden_size: int = 256,
                 bottleneck_size: int = 64, num_layers: int = 2,
                 num_layers_per_block: int = 1, output_size: int = 256,
                 dropout: float = 0.0, bidirectional: bool = True,
                 use_layer_norm: bool = True, use_relu: bool = True,
                 use_mixing: bool = False, use_residual: bool = True,
                 use_feed_forward: bool = True):
        super().__init__()
        lstm_out = lstm_hidden_size * (2 if bidirectional else 1)
        affine = affine_hidden_size if use_mixing else lstm_out
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"block_{i}", LSTMBlock(
                input_size if i == 0 else affine, lstm_hidden_size, affine,
                generator, num_layers=num_layers_per_block,
                bottleneck_size=bottleneck_size,
                output_size=output_size if i == num_layers - 1 else affine,
                dropout=dropout, bidirectional=bidirectional,
                use_layer_norm=use_layer_norm, use_relu=use_relu,
                use_mixing=use_mixing, use_residual=use_residual,
                use_feed_forward=use_feed_forward))

    def forward(self, x: torch.Tensor, hxs: Optional[LayerStates] = None
                ) -> Tuple[torch.Tensor, LayerStates]:
        new_states: LayerStates = []
        for i in range(self.num_layers):
            x, hx = getattr(self, f"block_{i}")(
                x, None if hxs is None else hxs[i])
            new_states.append(hx)
        return x, new_states


class LSTMSampler(nn.Module):
    """Uni-LSTM + stride subsample (reference lstm_sampler.py:6-34):
    h[:, rate-1::rate] keeps every ``decline_rate``-th hidden state."""

    def __init__(self, hidden_size: int, num_layers: int, dropout: float,
                 decline_rate: int, generator: torch.Generator):
        super().__init__()
        self.decline_rate = decline_rate
        self.sampler = TorchLSTM(hidden_size, hidden_size, generator,
                                 num_layers=num_layers, dropout=dropout)

    def forward(self, x, hx=None):
        h, hx = self.sampler(x, hx)
        return h[:, self.decline_rate - 1::self.decline_rate, :], hx
