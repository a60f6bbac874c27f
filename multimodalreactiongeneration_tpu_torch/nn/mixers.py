"""Recurrent and attention mixer blocks and their layered stacks.

Counterpart of ``multimodalreactiongeneration_tpu/nn/mixers.py`` for the
pieces the Metaformer decode path runs: ``RecurrentMixerBlock`` /
``RecurrentMixerLayerd`` (LSTM kind, single inner layer) with the fused
stack dispatch, and ``MHAMixerBlock`` / ``MHAMixerLayerd`` on their
shared-raw (decode) and masked full-sequence paths. Submodule names
follow the flax tree (``block_i``, ``mixer``, ``mixer_norm``,
``feed_forward``, ``mha_i``). Recurrent stacks return their fresh
states, as in the JAX package (PARITY #1).

Not ported yet: the MLP and GRU mixers, bidirectional and multi-layer
LSTM mixers, and the per-block KV-cache decode path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.attention import TorchMHA
from multimodalreactiongeneration_tpu_torch.nn.basic import (
    FeedForward,
    LayerNorm,
    set_nonlinearity,
)
from multimodalreactiongeneration_tpu_torch.nn.recurrent import TorchLSTM
from multimodalreactiongeneration_tpu_torch.ops.mixer_stack import (
    mixer_stack_forward,
)

# decode-sized sequences stay on the plain recurrence (the JAX package's
# resolve_impl rule: under 16 steps the kernel's set-up costs more than
# it saves)
MIN_FUSED_STEPS = 16


def _residual_wrap(y, x, use_residual, norm):
    if not use_residual:
        return y
    y = y + x
    if norm is not None:
        y = norm(y)
    return y


def _feed_forward(hidden_size, generator, cfg_owner) -> FeedForward:
    return FeedForward(
        hidden_size=hidden_size,
        generator=generator,
        bottleneck_size=cfg_owner.bottleneck_size,
        nonlinearity=cfg_owner.nonlinearity,
        residual=cfg_owner.residual,
        residual_layer_norm=cfg_owner.residual_layer_norm,
        use_bias=cfg_owner.use_bias,
    )


class RecurrentMixerBlock(nn.Module):
    """LSTM mixer + FFN (reference mixer_block.py:355-507)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        kind: str = "lstm",
        num_layers: int = 1,
        bidirectional: bool = False,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        if kind != "lstm" or num_layers != 1 or bidirectional:
            raise NotImplementedError(
                "the port has the single-layer unidirectional LSTM mixer "
                f"only (kind={kind!r}, num_layers={num_layers}, "
                f"bidirectional={bidirectional})"
            )
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.bottleneck_size = bottleneck_size
        self.use_bias = use_bias
        self.mixer = TorchLSTM(hidden_size, hidden_size, generator)
        self.mixer_norm = (
            LayerNorm(hidden_size) if residual and residual_layer_norm
            else None
        )
        self.feed_forward = _feed_forward(hidden_size, generator, self)

    def forward(self, x, hx=None):
        y, new_hx = self.mixer(x, hx)
        y = _residual_wrap(y, x, self.residual, self.mixer_norm)
        return self.feed_forward(y), new_hx


class MHAMixerBlock(nn.Module):
    """MHA mixer (N inner layers) + FFN (reference mixer_block.py:510-603).

    attn_mask given, shared_raw None -> full-sequence masked attention;
    shared_raw = (x_full, mask) -> attend a raw ring buffer with folded
    projections (the shared-KV decode path)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        num_layers: int = 1,
        num_heads: int = 1,
        kdim: Optional[int] = None,
        vdim: Optional[int] = None,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.bottleneck_size = bottleneck_size
        self.use_bias = use_bias
        for i in range(num_layers):
            setattr(self, f"mha_{i}", TorchMHA(
                hidden_size, num_heads, generator, kdim=kdim, vdim=vdim,
                use_bias=use_bias,
            ))
        self.mixer_norm = (
            LayerNorm(hidden_size) if residual and residual_layer_norm
            else None
        )
        self.feed_forward = _feed_forward(hidden_size, generator, self)

    def forward(self, query, key=None, value=None, attn_mask=None,
                shared_raw=None):
        act = set_nonlinearity(self.nonlinearity)
        y = query
        for i in range(self.num_layers):
            mha = getattr(self, f"mha_{i}")
            if shared_raw is not None:
                x_full, smask = shared_raw
                y_att = mha.attend_raw(y, x_full, smask)
            else:
                y_att = mha(y, key, value, attn_mask)
            if act is not None:
                y_att = act(y_att)
            y = y_att
        y = _residual_wrap(y, query, self.residual, self.mixer_norm)
        return self.feed_forward(y)


class RecurrentMixerLayerd(nn.Module):
    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        kind: str = "lstm",
        num_layerd: int = 1,
        num_internal_layer: int = 1,
        dropout: float = 0.0,
        bidirectional: bool = False,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.kind = kind
        self.num_layerd = num_layerd
        self.num_internal_layer = num_internal_layer
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.use_bias = use_bias
        for i in range(num_layerd):
            setattr(self, f"block_{i}", RecurrentMixerBlock(
                hidden_size, generator, kind=kind,
                num_layers=num_internal_layer, bidirectional=bidirectional,
                nonlinearity=nonlinearity, residual=residual,
                residual_layer_norm=residual_layer_norm,
                bottleneck_size=bottleneck_size, use_bias=use_bias,
            ))

    def forward(self, x, hx: Optional[List[Any]] = None):
        fused = self._fused_stack(x, hx)
        if fused is not None:
            return fused
        new_states = []
        for i in range(self.num_layerd):
            x, bhx = getattr(self, f"block_{i}")(
                x, None if hx is None else hx[i]
            )
            new_states.append(bhx)
        return x, new_states

    def _fused_stack(self, x, hx):
        """Run the whole block stack through ``mixer_stack_forward`` (the
        CUDA kernel on the card, its plain version on the CPU); returns
        None to fall back to the per-block modules. Same gate as the JAX
        package, less its TPU backend test."""
        if not (
            self.kind == "lstm"
            and self.num_internal_layer == 1
            and not self.bidirectional
            and self.num_layerd > 1
            and self.residual
            and self.residual_layer_norm
            and set_nonlinearity(self.nonlinearity) is None
            and self.use_bias
            and (self.dropout == 0 or not self.training)
            and x.shape[-1] == self.hidden_size
            and x.shape[1] >= MIN_FUSED_STEPS
        ):
            return None
        blocks = [getattr(self, f"block_{i}") for i in range(self.num_layerd)]

        def st(fn):
            return torch.stack([fn(b) for b in blocks]).float().contiguous()

        w_ih_t = st(lambda b: b.mixer.weight_ih_l0.T)
        w_hh_t = st(lambda b: b.mixer.weight_hh_l0.T)
        b_g = st(lambda b: b.mixer.bias_ih_l0 + b.mixer.bias_hh_l0)
        g1 = st(lambda b: b.mixer_norm.weight)
        b1 = st(lambda b: b.mixer_norm.bias)
        w_ff = st(lambda b: b.feed_forward.feedforward.weight.T)
        b_ff = st(lambda b: b.feed_forward.feedforward.bias)
        g2 = st(lambda b: b.feed_forward.LayerNorm_0.weight)
        b2 = st(lambda b: b.feed_forward.LayerNorm_0.bias)
        n, batch, h = self.num_layerd, x.shape[0], self.hidden_size
        if hx is None:
            h0 = x.new_zeros(n, batch, h, dtype=torch.float32)
            c0 = torch.zeros_like(h0)
        else:
            h0 = torch.cat([p[0] for p in hx]).float().contiguous()
            c0 = torch.cat([p[1] for p in hx]).float().contiguous()
        y, (hn, cn) = mixer_stack_forward(
            x.float().contiguous(), w_ih_t, b_g, w_hh_t, w_ff, b_ff,
            g1, b1, g2, b2, h0, c0,
        )
        new_states = [(hn[l][None], cn[l][None]) for l in range(n)]
        return y.to(x.dtype), new_states


class MHAMixerLayerd(nn.Module):
    """Cross-attention stack (reference mixer_block.py:846-963)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        self_attention: bool = False,
        num_layerd: int = 1,
        num_internal_layer: int = 1,
        num_heads: int = 1,
        dropout: float = 0.0,
        kdim: Optional[int] = None,
        vdim: Optional[int] = None,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.self_attention = self_attention
        self.num_layerd = num_layerd
        for i in range(num_layerd):
            setattr(self, f"block_{i}", MHAMixerBlock(
                hidden_size, generator, num_layers=num_internal_layer,
                num_heads=num_heads, kdim=kdim, vdim=vdim,
                nonlinearity=nonlinearity, residual=residual,
                residual_layer_norm=residual_layer_norm,
                bottleneck_size=bottleneck_size, use_bias=use_bias,
            ))

    def forward(
        self,
        x: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        shared_raw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        query = x
        if self.self_attention:
            if shared_raw is not None:
                raise ValueError(
                    "shared_raw is a cross-attention decode path; "
                    "self-attention stacks re-key per block"
                )
            key, value = query, query
        if shared_raw is None and (key is None or value is None):
            raise ValueError("key/value required when self_attention is False")
        for i in range(self.num_layerd):
            if self.self_attention and i > 0:
                key = value = query
            query = getattr(self, f"block_{i}")(
                query, key, value, attn_mask, shared_raw
            )
        return query, [None] * self.num_layerd


def build_mixer_layerd(mixer_type: str, configs: Dict[str, Any],
                       generator: torch.Generator) -> nn.Module:
    """MixerLayerdFactory equivalent for the ported mixer kinds."""
    if mixer_type == "lstm":
        return RecurrentMixerLayerd(kind="lstm", generator=generator,
                                    **configs)
    if mixer_type == "mha":
        return MHAMixerLayerd(generator=generator, **configs)
    if mixer_type in ("mlp", "gru"):
        raise NotImplementedError(
            f"{mixer_type!r} mixers are not ported yet (the Metaformer "
            "decode slice runs lstm and mha mixers only)"
        )
    raise ValueError(f"mixer_type must be mlp/gru/lstm/mha, got {mixer_type!r}")
