"""LSTMwithSample: the streaming autoregressive head-motion model
(lstm_with_sampling).

Counterpart of ``multimodalreactiongeneration_tpu/models/
lstm_with_sampling.py`` (reference lstm_with_sample.py:59-232):

  * acoustic Dense (81 -> sampler_hidden), then ``LSTMSampler``: a
    unidirectional stacked LSTM (on the card, over 16 steps or more, the
    stacked-LSTM wavefront kernels, K9) subsampled 8x, 100 Hz -> 12.5 fps;
  * concat [sampled audio | partner motion | self motion], a feature
    Dense, a unidirectional ``LSTMLayerd`` without FFN (its blocks'
    LSTMs are single layers: K7 from 16 steps on), then a bottleneck FFN
    to the 18 motion dims;
  * the forward prepends each modality's leading (warmup) segment; the
    training step slices the leading frames off.

State = (sampler state (h, c) each (L, B, H), [each block's (h, c)]).
The parameter names are the flax paths, so ``models/weights.py``
converts a JAX parameter tree 1:1.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.nn.basic import dense
from multimodalreactiongeneration_tpu_torch.nn.lstm_block import (
    LSTMLayerd,
    LSTMSampler,
)

ModelState = Tuple[Any, List[Any]]


def derived_sizes(model_cfg: dict) -> dict:
    """Input-size arithmetic (reference :76-90)."""
    acoustic_fps = model_cfg["sampling_rate"] / model_cfg["shift"]
    ratio = int(acoustic_fps / model_cfg["pred_fps"])
    motion_base = (
        int(model_cfg["use_centroid"]) + int(model_cfg["use_angle"])
    ) * 3
    motion_input = motion_base * (model_cfg["delta_order"] + 1) * 2
    return dict(
        ratio=ratio,
        motion_input_size=motion_input,
        acoustic_input_size=(model_cfg["nmels"] + 1)
        * (model_cfg["delta_order"] + 1),
        prediction_input_size=motion_input + model_cfg["sampler_hidden_size"],
        output_size=motion_input // 2,
    )


class LSTMwithSample(nn.Module):
    """``generator`` draws every initial weight (distribution-matched to
    the JAX initialisers); the parameters are placed on ``device``,
    ``cuda:0`` when none is named (``resolve_device``)."""

    def __init__(
        self,
        cfg: dict,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sizes = derived_sizes(cfg)
        self.ratio = sizes["ratio"]
        hidden, sampler_hidden = cfg["hidden_size"], cfg["sampler_hidden_size"]
        self.use_relu = cfg["use_relu"]
        self.acoustic_projection = dense(sizes["acoustic_input_size"],
                                         sampler_hidden, generator)
        self.sampling_lstm = LSTMSampler(
            sampler_hidden, cfg["sampler_num_layers"],
            cfg["sampler_dropout_rate"], sizes["ratio"], generator)
        self.feature_projection = dense(sizes["prediction_input_size"],
                                        hidden, generator)
        self.layerd_lstm = LSTMLayerd(
            hidden, hidden, generator, affine_hidden_size=hidden,
            bottleneck_size=cfg["bottleneck_size"],
            num_layers=cfg["num_layers"],
            num_layers_per_block=cfg["num_lstm"], output_size=hidden,
            dropout=cfg["dropout_rate"], bidirectional=False,
            use_layer_norm=cfg["use_layer_norm"],
            use_mixing=cfg["use_mixing"], use_residual=cfg["use_residual"],
            use_feed_forward=False)
        self.ff_input = dense(hidden, cfg["bottleneck_size"], generator)
        self.ff_mapping = dense(cfg["bottleneck_size"], sizes["output_size"],
                                generator)
        self.to(device)

    def forward(
        self,
        acoustic_partner: torch.Tensor,  # (B, Ta, 81)
        motion_partner: torch.Tensor,    # (B, Tm, 18)
        motion_self: torch.Tensor,       # (B, Tm, 18)
        leading_acoustic_partner: Optional[torch.Tensor] = None,
        leading_motion_partner: Optional[torch.Tensor] = None,
        leading_motion_self: Optional[torch.Tensor] = None,
        state: Optional[ModelState] = None,
    ) -> Tuple[torch.Tensor, ModelState]:
        def cat_lead(lead, main):
            if lead is None or lead.shape[1] == 0:
                return main
            return torch.cat([lead, main], dim=1)

        acoustic = cat_lead(leading_acoustic_partner, acoustic_partner)
        motion_p = cat_lead(leading_motion_partner, motion_partner)
        motion_s = cat_lead(leading_motion_self, motion_self)
        hx_sampler, hxs = (None, None) if state is None else state

        a, hx_sampler = self.sampling_lstm(
            self.acoustic_projection(acoustic), hx_sampler)
        if a.shape[1] != motion_p.shape[1] or a.shape[1] != motion_s.shape[1]:
            raise ValueError(
                f"rate mismatch: sampled audio {a.shape[1]} vs motion "
                f"{motion_p.shape[1]}/{motion_s.shape[1]} (ratio "
                f"{self.ratio})")
        feats = self.feature_projection(
            torch.cat([a, motion_p, motion_s], dim=-1))
        h, hxs = self.layerd_lstm(feats, hxs)
        y = self.ff_input(h)
        if self.use_relu:
            y = torch.relu(y)
        return self.ff_mapping(y), (hx_sampler, hxs)
