"""Multimodal metaformer (reference multi_modal_metaformer.py:82-509).

Counterpart of ``multimodalreactiongeneration_tpu/nn/metaformer.py``:
per-modal feature Linear into hidden_dim; each block embeds the main
modality (and, in the encoding block, the other modalities), integrates
it into every other modality by cross-attention, concatenates, projects
and runs an FFN; an output FFN maps to the motion feature dim.

States are plain Python structures threaded through ``forward``: per
block ``{"emb": [...], "crm": [...]}``; in the shared-KV decode layout
``{"shared": [raw caches], "blocks": [...]}``, where ONE raw ring buffer
per other modality holds block 0's encodings and every integrator
attends it with folded projections (``TorchMHA.attend_raw``).

The encoding block owns the other-modality encoders (``emb_1`` ...)
whether or not a given call runs them: under ``precomputed_others`` the
hoisted decode path skips them, as the JAX package leaves their params
unvisited.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.infer.cache import (
    raw_cache_extend,
)
from multimodalreactiongeneration_tpu_torch.nn.basic import (
    FeedForward,
    LayerNorm,
    dense,
)
from multimodalreactiongeneration_tpu_torch.nn.mixers import (
    MHAMixerLayerd,
    build_mixer_layerd,
)

BlockState = Dict[str, List[Any]]


class MultiModalMetaformerBlock(nn.Module):
    """embed -> integrate -> feedforward (reference :220-338)."""

    def __init__(
        self,
        num_modal: int,
        main_mixer: Tuple[str, Dict[str, Any]],
        other_mixers: Sequence[Tuple[str, Dict[str, Any]]],
        integrate_configs: Sequence[Dict[str, Any]],
        feedforward_config: Dict[str, Any],
        generator: torch.Generator,
        encode_other_modal: bool = False,
    ):
        super().__init__()
        self.num_modal = num_modal
        self.encode_other_modal = encode_other_modal
        self.mixer_types = [main_mixer[0]] + [t for t, _ in other_mixers]
        self.emb_0 = build_mixer_layerd(main_mixer[0], main_mixer[1],
                                        generator)
        if encode_other_modal:
            for i, (mtype, cfg) in enumerate(other_mixers, start=1):
                setattr(self, f"emb_{i}",
                        build_mixer_layerd(mtype, cfg, generator))
        self.n_integrate = len(integrate_configs)
        for i, cfg in enumerate(integrate_configs):
            setattr(self, f"integrate_{i}", MHAMixerLayerd(
                generator=generator, **{**cfg, "self_attention": False}
            ))
        hidden = feedforward_config["hidden_size"]
        self.cat_linear = dense(hidden * self.n_integrate, hidden, generator)
        self.feed_forward = FeedForward(generator=generator,
                                        **feedforward_config)

    def _embed(self, i: int, x, state, self_mask):
        layerd = getattr(self, f"emb_{i}")
        if self.mixer_types[i] == "mha":
            y, _ = layerd(x, attn_mask=self_mask)
            return y, state
        return layerd(x, state)

    def encode_only(self, other_modals, self_masks=None):
        """Other-modality encoder pass only (the AR-decode hoist): run
        emb_1..emb_n full-sequence from fresh states."""
        assert self.encode_other_modal, "encode_only needs the encoder block"
        self_masks = self_masks or [None] * self.num_modal
        return [
            self._embed(i, x, None, self_masks[i])[0]
            for i, x in enumerate(other_modals, start=1)
        ]

    def forward(
        self,
        main_modal: torch.Tensor,
        other_modals: List[torch.Tensor],
        state: Optional[BlockState] = None,
        self_masks=None,
        cross_masks=None,
        shared_state: Optional[List[Any]] = None,
        shared_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
        encode: Optional[bool] = None,
    ):
        encode = self.encode_other_modal if encode is None else encode
        n_others = self.num_modal - 1
        self_masks = self_masks or [None] * self.num_modal
        cross_masks = cross_masks or [None] * n_others
        emb_state = state["emb"] if state else [None] * self.num_modal
        crm_state = state["crm"] if state else [None] * n_others
        new_state: BlockState = {"emb": [], "crm": []}

        n_emb = self.num_modal if encode else 1
        inputs = [main_modal] + (list(other_modals) if encode else [])
        embedded = []
        for i in range(n_emb):
            y, st = self._embed(i, inputs[i], emb_state[i], self_masks[i])
            embedded.append(y)
            new_state["emb"].append(st)
        main_out = embedded[0]
        if encode:
            other_modals = embedded[1:]

        if shared_state is not None:
            assert encode, "shared_state belongs to the encoding block"
            new_state["shared"] = []
            shared_kv = []
            for i in range(n_others):
                c2, x_full, mask = raw_cache_extend(
                    shared_state[i], other_modals[i], chunk_mask=cross_masks[i]
                )
                new_state["shared"].append(c2)
                shared_kv.append((x_full, mask))

        ys = []
        for i in range(self.n_integrate):
            integ = getattr(self, f"integrate_{i}")
            if shared_kv is not None:
                y, st = integ(main_out, shared_raw=shared_kv[i])
            else:
                if crm_state[i] is not None:
                    raise NotImplementedError(
                        "per-block KV caches are not ported; use the "
                        "shared-KV decode layout"
                    )
                y, st = integ(main_out, key=other_modals[i],
                              value=other_modals[i],
                              attn_mask=cross_masks[i])
            ys.append(y)
            new_state["crm"].append(st)
        merged = self.cat_linear(torch.cat(ys, dim=-1))
        out = self.feed_forward(merged)
        if shared_kv is not None:
            return out, shared_kv, new_state
        return out, list(other_modals), new_state


class MultiModalMetaformer(nn.Module):
    """Stack of metaformer blocks + output FFN (reference :341-509)."""

    def __init__(
        self,
        modal_num: int,
        hidden_dim: int,
        num_layer: int,
        main_modal_feature_dim: int,
        other_modal_feature_dim: Sequence[int],
        main_mixer,
        other_mixers,
        integrate_configs,
        feedforward_config,
        output_feedforward_config,
        generator: torch.Generator,
        repeat_with_encoder: bool = False,
        interlayer_residual: bool = False,
        interlayer_residual_norm: bool = True,
    ):
        super().__init__()
        self.modal_num = modal_num
        self.num_layer = num_layer
        self.repeat_with_encoder = repeat_with_encoder
        self.interlayer_residual = interlayer_residual
        self.interlayer_residual_norm = interlayer_residual_norm
        self.feature_embedding_0 = dense(main_modal_feature_dim, hidden_dim,
                                         generator)
        for i, dim in enumerate(other_modal_feature_dim, start=1):
            setattr(self, f"feature_embedding_{i}",
                    dense(dim, hidden_dim, generator))
        for layer in range(num_layer):
            encode = layer == 0 or repeat_with_encoder
            setattr(self, f"block_{layer}", MultiModalMetaformerBlock(
                num_modal=modal_num,
                main_mixer=main_mixer,
                other_mixers=other_mixers if encode else (),
                integrate_configs=integrate_configs,
                feedforward_config=feedforward_config,
                generator=generator,
                encode_other_modal=encode,
            ))
            if interlayer_residual and interlayer_residual_norm:
                setattr(self, f"inter_norm_{layer}", LayerNorm(hidden_dim))
        self.output_ff = FeedForward(generator=generator,
                                     **output_feedforward_config)

    def encode_others(self, other_modals, self_masks=None):
        """Hoisted other-modality encoder pass: feature embeddings +
        block_0's encoder stacks, full-sequence."""
        others = [
            getattr(self, f"feature_embedding_{i + 1}")(om)
            for i, om in enumerate(other_modals)
        ]
        return self.block_0.encode_only(others, self_masks)

    def forward(
        self,
        main_modal: torch.Tensor,
        other_modals: List[Optional[torch.Tensor]],
        states=None,
        self_masks=None,
        cross_masks=None,
        precomputed_others: Optional[List[torch.Tensor]] = None,
    ):
        main = self.feature_embedding_0(main_modal)
        others = (
            []
            if precomputed_others is not None
            else [
                getattr(self, f"feature_embedding_{i + 1}")(om)
                for i, om in enumerate(other_modals)
            ]
        )
        shared_mode = isinstance(states, dict)
        if shared_mode and self.repeat_with_encoder:
            raise ValueError(
                "shared-KV decode requires repeat_with_encoder=False "
                "(blocks must reuse block-0 encodings)"
            )
        block_states = states["blocks"] if shared_mode else states
        shared = states["shared"] if shared_mode else None

        new_states: List[BlockState] = []
        new_shared = None
        shared_kv_pre = None
        if precomputed_others is not None:
            if not shared_mode:
                raise ValueError(
                    "precomputed_others requires the shared-KV decode "
                    "layout (states = {'shared': ..., 'blocks': ...})"
                )
            new_shared, shared_kv_pre = [], []
            cm = cross_masks or [None] * (self.modal_num - 1)
            for i, enc in enumerate(precomputed_others):
                c2, x_full, mask = raw_cache_extend(
                    shared[i], enc, chunk_mask=cm[i]
                )
                new_shared.append(c2)
                shared_kv_pre.append((x_full, mask))

        for layer in range(self.num_layer):
            encode = (
                layer == 0 and precomputed_others is None
            ) or self.repeat_with_encoder
            first_shared = (
                shared_mode and layer == 0 and shared_kv_pre is None
            )
            if shared_kv_pre is not None:
                kv_arg = shared_kv_pre
            elif shared_mode and layer > 0:
                kv_arg = others
            else:
                kv_arg = None
            y, others, new_st = getattr(self, f"block_{layer}")(
                main,
                others,
                None if block_states is None else block_states[layer],
                self_masks,
                cross_masks,
                shared_state=shared if first_shared else None,
                shared_kv=kv_arg,
                encode=encode,
            )
            if first_shared:
                new_shared = new_st.pop("shared")
            if self.interlayer_residual:
                y = y + main
                if self.interlayer_residual_norm:
                    y = getattr(self, f"inter_norm_{layer}")(y)
            main = y
            new_states.append(new_st)

        out = self.output_ff(main)
        if shared_mode:
            return out, others, {"shared": new_shared, "blocks": new_states}
        return out, others, new_states
