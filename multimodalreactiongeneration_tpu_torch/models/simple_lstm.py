"""SimpleLSTM: the windowed one-step head-motion predictor (simple_lstm).

Counterpart of ``multimodalreactiongeneration_tpu/models/simple_lstm.py``
(reference mr_gen/model/simple_lstm/simple_lstm.py):

  * acoustic encoder: Dense (81 -> affine), then a bidirectional
    ``LSTMLayerd``; over the 120 audio frames of a window its single-layer
    LSTMs take the kernels on the card (K7 by default, K8 under
    ``MRGEN_FUSED_DW=0``, ``nn/recurrent.py single_layer_route``);
  * motion encoder: Dense (18 -> affine), then a bidirectional
    ``LSTMLayerd`` over the 15-frame context (the plain recurrence);
  * ``MultimodalAttention``: layers of cross-modal MHA (Q = motion,
    K/V = audio, kdim/vdim), a projection Dense, residual and LayerNorm;
    unmasked, so plain torch ops, as the JAX package computes it outside
    any Pallas kernel;
  * decoder: a bidirectional ``LSTMLayerd``, the last time step, then a
    2-layer mapping to the 18 motion dims;
  * ``simple_lstm_loss``: MSE with sqrt(delta_loss_scale) on the delta
    channels, the deltas rebuilt from the static prediction when
    ``all_static`` (``split_and_form``), the -100 filler rows zeroed by
    ``row_mask`` after that.

The parameter names are the flax paths, so ``models/weights.py`` converts
a JAX parameter tree 1:1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.nn.attention import TorchMHA
from multimodalreactiongeneration_tpu_torch.nn.basic import (
    LayerNorm,
    dense,
)
from multimodalreactiongeneration_tpu_torch.nn.lstm_block import LSTMLayerd


class MultimodalAttention(nn.Module):
    """Cross-modal attention stack (reference multi_modal_att.py:62-91):
    per layer ``att_{i}`` (MHA with kdim/vdim), ``projection_{i}`` and,
    with the residual, ``norm_{i}``."""

    def __init__(self, modal1_feat_size: int, modal2_feat_size: int,
                 generator: torch.Generator, num_head: int = 1,
                 num_layers: int = 1, dropout: float = 0.0,
                 use_residual: bool = True, use_layer_norm: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.use_residual = use_residual
        for i in range(num_layers):
            setattr(self, f"att_{i}", TorchMHA(
                modal1_feat_size, num_head, generator,
                kdim=modal2_feat_size, vdim=modal2_feat_size,
                dropout=dropout))
            setattr(self, f"projection_{i}",
                    dense(modal1_feat_size, modal1_feat_size, generator))
            if use_residual and use_layer_norm:
                setattr(self, f"norm_{i}", LayerNorm(modal1_feat_size))

    def forward(self, modal1: torch.Tensor, modal2: torch.Tensor
                ) -> torch.Tensor:
        for i in range(self.num_layers):
            y = getattr(self, f"att_{i}")(modal1, modal2, modal2)
            y = getattr(self, f"projection_{i}")(y)
            if self.use_residual:
                y = y + modal1
                norm = getattr(self, f"norm_{i}", None)
                if norm is not None:
                    y = norm(y)
            modal1 = y
        return modal1


def _layerd(cfg: dict, prefix: str, input_size: int, generator,
            bottleneck: Optional[int] = None) -> LSTMLayerd:
    """An encoder's or the decoder's ``LSTMLayerd`` from the model group's
    ``{prefix}_*`` keys (``bottleneck`` only where the JAX model passes
    one: the decoder)."""
    opt = (lambda k: cfg[f"{prefix}_{k}"]) if prefix == "decoder" else (
        lambda k: cfg[k])
    kw = {} if bottleneck is None else {"bottleneck_size": bottleneck}
    return LSTMLayerd(
        input_size, cfg[f"{prefix}_lstm_size"], generator,
        affine_hidden_size=cfg[f"{prefix}_affine_size"],
        num_layers=cfg[f"{prefix}_num_layers"],
        num_layers_per_block=cfg[f"{prefix}_num_lstm"],
        output_size=cfg[f"{prefix}_output_size"],
        dropout=cfg["dropout_rate"], bidirectional=opt("bidirectional"),
        use_layer_norm=opt("use_layer_norm"), use_relu=opt("use_relu"),
        use_mixing=opt("use_mixing"), use_residual=opt("use_residual"),
        **kw)


class SimpleLSTM(nn.Module):
    """``cfg`` is the model group of ``configs/simple_lstm.yaml``;
    ``generator`` draws every initial weight (distribution-matched to the
    JAX initialisers); the parameters are placed on ``device``, ``cuda:0``
    when none is named (``resolve_device``)."""

    def __init__(self, cfg: dict, generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.use_relu = cfg["decoder_use_relu"]
        self.acoustic_embed = dense(cfg["acostic_feat_size"],
                                    cfg["acostic_affine_size"], generator)
        self.acoustic_lstm = _layerd(cfg, "acostic",
                                     cfg["acostic_affine_size"], generator)
        self.motion_embed = dense(cfg["motion_feat_size"],
                                  cfg["motion_affine_size"], generator)
        self.motion_lstm = _layerd(cfg, "motion", cfg["motion_affine_size"],
                                   generator)
        self.multimodal_att = MultimodalAttention(
            cfg["motion_output_size"], cfg["acostic_output_size"], generator,
            num_head=cfg["att_heads"], num_layers=cfg["att_num_layers"],
            dropout=cfg["dropout_rate"],
            use_residual=cfg["att_use_residual"],
            use_layer_norm=cfg["att_use_layer_norm"])
        self.decoder_lstm = _layerd(cfg, "decoder", cfg["motion_output_size"],
                                    generator,
                                    bottleneck=cfg["decoder_bottleneck_size"])
        self.mapping_input = dense(cfg["decoder_output_size"],
                                   cfg["decoder_mapping_size"], generator)
        self.mapping_output = dense(cfg["decoder_mapping_size"],
                                    cfg["output_size"], generator)
        self.to(device)

    def forward(self, acoustic_feature: torch.Tensor,  # (B, Ta, 81)
                motion_feature: torch.Tensor,           # (B, Tm, 18)
                ) -> torch.Tensor:
        """-> (B, 1, output_size): the next frame."""
        a, _ = self.acoustic_lstm(self.acoustic_embed(acoustic_feature))
        m, _ = self.motion_lstm(self.motion_embed(motion_feature))
        # Q = motion, K/V = audio (reference :186)
        d, _ = self.decoder_lstm(self.multimodal_att(m, a))
        d = self.mapping_input(d[:, -1:, :])
        if self.use_relu:
            d = torch.relu(d)
        return self.mapping_output(d)


def split_and_form(x: torch.Tensor, y: torch.Tensor, delta_order: int,
                   base_size: int) -> torch.Tensor:
    """Recompute deltas from the static prediction (reference :223-237).

    x: (B, T, D) motion context, y: (B, 1, D) prediction. Only y's first
    ``base_size`` channels are kept; delta1/2 are rebuilt against the last
    context frame."""
    if delta_order == 0:
        return y
    y_s = y[..., :base_size]
    x_last = x[:, -1:, :]
    v = y_s - x_last[..., :base_size]
    if delta_order == 1:
        return torch.cat([y_s, v], dim=-1)
    a = v - x_last[..., base_size:2 * base_size]
    return torch.cat([y_s, v, a], dim=-1)


def delta_loss_scaler(feat_dim: int, delta_order: int,
                      delta_loss_scale: float, device=None) -> torch.Tensor:
    """sqrt(scale) on the delta channels (reference :246-250)."""
    s = torch.ones(feat_dim, device=device)
    s[feat_dim // (delta_order + 1):] = delta_loss_scale ** 0.5
    return s


def mse_loss(y: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(y - target))


def static_base(metrics_cfg: dict) -> int:
    """Static channels of a frame: 3 each for centroid and angle."""
    return (int(metrics_cfg["use_centroid"])
            + int(metrics_cfg["use_angle"])) * 3


def simple_lstm_loss(
    y: torch.Tensor, target: torch.Tensor, motion_feature: torch.Tensor,
    model_cfg: dict, metrics_cfg: dict,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training loss (reference :239-255). Returns (loss, the masked
    prediction). ``row_mask`` (broadcastable, 1 = real row) zeroes the -100
    filler rows AFTER ``split_and_form``, so the all_static delta
    recompute cannot leak filler into the loss."""
    delta_order = metrics_cfg["delta_order"]
    if model_cfg.get("all_static", False):
        y = split_and_form(motion_feature, y, delta_order,
                           static_base(metrics_cfg))
    if row_mask is not None:
        m = row_mask.to(y.dtype)
        y = y * m
        target = target * m
    scaler = delta_loss_scaler(y.shape[-1], delta_order,
                               model_cfg.get("delta_loss_scale", 1.0),
                               y.device)
    return mse_loss(y * scaler, target * scaler), y
