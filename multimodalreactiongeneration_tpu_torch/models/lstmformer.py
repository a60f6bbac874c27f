"""Metaformer ("lstmformer"): multimodal metaformer head-motion model.

Counterpart of ``multimodalreactiongeneration_tpu/models/lstmformer.py``:
modalities [audio, motion_partner, motion_self] with the main modality
at ``main_modal_idx``; the forward concatenates lead+seq, builds the
rectangular cross-rate and self-attention masks and runs the
metaformer. The parameter tree mirrors the flax paths
(``metaformer.block_0.emb_0.block_0.mixer.weight_ih_l0`` ...), so
``models/weights.py`` converts a JAX parameter tree 1:1.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.nn.metaformer import (
    MultiModalMetaformer,
)
from multimodalreactiongeneration_tpu_torch.ops.masks import (
    merged_attention_mask,
    rectangular_causal_mask,
)


def derived_sizes(model_cfg: dict) -> dict:
    """Feature-size / rate arithmetic (reference :87-117)."""
    pred_fps = model_cfg["pred_fps"]
    acoustic_fps = model_cfg["sampling_rate"] / model_cfg["shift"]
    ratio = acoustic_fps / pred_fps
    if ratio != int(ratio):
        raise ValueError("pred_fps must divide acoustic_fps")
    motion_base = (
        int(model_cfg["use_centroid"]) + int(model_cfg["use_angle"])
    ) * 3
    return dict(
        ratio=int(ratio),
        acoustic_fps=acoustic_fps,
        acoustic_input_size=(model_cfg["nmels"] + 1)
        * (model_cfg["delta_order"] + 1),
        motion_input_size=motion_base * (model_cfg["delta_order"] + 1),
    )


def context_budgets(model_cfg: dict) -> List[int]:
    """Per-other-modality KV budgets in tokens (reference :98-110)."""
    sizes = derived_sizes(model_cfg)
    budgets = []
    modalities = list(model_cfg["modalities"])
    modalities.pop(model_cfg["main_modal_idx"])
    for modal in modalities:
        if modal == "audio":
            budgets.append(
                int(model_cfg["max_context_len"] * sizes["acoustic_fps"])
            )
        elif modal == "motion":
            budgets.append(
                int(model_cfg["max_context_len"] * model_cfg["pred_fps"])
            )
        else:
            raise ValueError(f"invalid modality {modal!r}")
    return budgets


def _layerd_config(mixer_type: str, cfg: dict, num_layerd: int) -> dict:
    common = dict(
        hidden_size=cfg["hidden_size"],
        num_layerd=num_layerd,
        num_internal_layer=cfg["num_internal_layer"],
        nonlinearity=cfg["nonlinearity"],
        residual=cfg["residual"],
        residual_layer_norm=cfg["residual_layer_norm"],
        bottleneck_size=cfg["bottleneck_size"],
        use_bias=cfg["bias"],
    )
    if mixer_type in ("gru", "lstm"):
        common.update(dropout=cfg["dropout"], bidirectional=False)
    elif mixer_type == "mha":
        common.update(
            num_heads=cfg["num_heads"],
            dropout=cfg["dropout"],
            kdim=cfg["hidden_size"],
            vdim=cfg["hidden_size"],
            self_attention=True,
        )
    return common


class Metaformer(nn.Module):
    """The flagship model. ``generator`` draws every initial weight
    (distribution-matched to the JAX initialisers); the parameters are
    placed on ``device``, ``cuda:0`` when none is named
    (``resolve_device``)."""

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
        main_idx = cfg["main_modal_idx"]
        other_types = list(cfg["emb_mixers"])
        main_type = other_types.pop(main_idx)
        integ = _layerd_config("mha", cfg, cfg["num_layerd"])
        integ["self_attention"] = False
        ff = dict(
            hidden_size=cfg["hidden_size"],
            bottleneck_size=cfg["bottleneck_size"],
            nonlinearity=cfg["ffn_nonlinearity"],
            residual=cfg["residual"],
            residual_layer_norm=cfg["residual_layer_norm"],
            use_bias=cfg["bias"],
        )
        out_ff = dict(
            hidden_size=cfg["hidden_size"],
            bottleneck_size=cfg["bottleneck_size"],
            output_size=sizes["motion_input_size"],
            nonlinearity=cfg["ffn_nonlinearity"],
            residual=False,
            use_bias=cfg["bias"],
        )
        self.metaformer = MultiModalMetaformer(
            modal_num=len(cfg["modalities"]),
            hidden_dim=cfg["hidden_size"],
            num_layer=cfg["num_block"],
            main_modal_feature_dim=sizes["motion_input_size"],
            other_modal_feature_dim=(
                sizes["acoustic_input_size"],
                sizes["motion_input_size"],
            ),
            main_mixer=(main_type,
                        _layerd_config(main_type, cfg, cfg["num_layerd"])),
            other_mixers=tuple(
                (t, _layerd_config(t, cfg, cfg["encoder_num_layer"]))
                for t in other_types
            ),
            # the training cross-masks are always merged_attention_mask
            # products (forward below), so the integrators' masked
            # attention takes rect_attention (nn/attention.py attend)
            integrate_configs=tuple(
                dict(integ, rect_pad_masks=True)
                for _ in range(len(cfg["modalities"]) - 1)
            ),
            feedforward_config=ff,
            output_feedforward_config=out_ff,
            generator=generator,
            repeat_with_encoder=cfg["repeat_with_encoder"],
            interlayer_residual=cfg["interlayer_residual"],
            interlayer_residual_norm=cfg["interlayer_residual_norm"],
        )
        self.to(device)

    def forward(
        self,
        acoustic_partner: Optional[torch.Tensor],
        motion_partner: Optional[torch.Tensor],
        motion_self: Optional[torch.Tensor],
        leading_acoustic_partner: Optional[torch.Tensor] = None,
        leading_motion_partner: Optional[torch.Tensor] = None,
        leading_motion_self: Optional[torch.Tensor] = None,
        states: Optional[Any] = None,
        *,
        use_masks: bool = True,
        encode_others_only: bool = False,
        precomputed_others: Optional[List[torch.Tensor]] = None,
    ):
        cfg = self.cfg

        def cat_lead(lead, main):
            if main is None or lead is None or lead.shape[1] == 0:
                return main
            return torch.cat([lead, main], dim=1)

        acoustic = cat_lead(leading_acoustic_partner, acoustic_partner)
        motion_p = cat_lead(leading_motion_partner, motion_partner)
        motion_s = cat_lead(leading_motion_self, motion_self)
        other_types = list(cfg["emb_mixers"])
        main_type = other_types.pop(cfg["main_modal_idx"])

        if encode_others_only:
            # hoisted other-modality encoder pass for AR decode: the full
            # (lead + seq) streams in, block-0 encodings out
            if any(t == "mha" for t in other_types):
                raise ValueError(
                    "encode_others_only does not support mha other-"
                    "modality embeddings (ring-buffer visibility differs "
                    "from a full-sequence causal mask); use the in-loop "
                    "decode path"
                )
            return self.metaformer.encode_others([acoustic, motion_p])

        self_masks = [None, None, None]
        cross_masks = [None, None]
        if use_masks:
            cross_masks = [
                merged_attention_mask(motion_s, acoustic),
                merged_attention_mask(motion_s, motion_p),
            ]
            if main_type == "mha":
                self_masks[0] = merged_attention_mask(motion_s, motion_s)
            if other_types[0] == "mha":
                self_masks[1] = merged_attention_mask(acoustic, acoustic)
            if other_types[1] == "mha":
                self_masks[2] = merged_attention_mask(motion_p, motion_p)
        elif states is not None:
            # decode steps: mha self-attention embeddings still need
            # intra-chunk causality
            dev = motion_s.device
            if main_type == "mha":
                n = motion_s.shape[1]
                self_masks[0] = rectangular_causal_mask(n, n, dev)
            if other_types[0] == "mha" and acoustic is not None:
                n = acoustic.shape[1]
                self_masks[1] = rectangular_causal_mask(n, n, dev)
            if other_types[1] == "mha" and motion_p is not None:
                n = motion_p.shape[1]
                self_masks[2] = rectangular_causal_mask(n, n, dev)

        y, _, new_states = self.metaformer(
            motion_s,
            [acoustic, motion_p],
            states,
            self_masks,
            cross_masks,
            precomputed_others=precomputed_others,
        )
        return y, new_states
