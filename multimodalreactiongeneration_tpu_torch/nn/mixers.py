"""Recurrent and attention mixer blocks and their layered stacks.

Counterpart of ``multimodalreactiongeneration_tpu/nn/mixers.py`` for the
pieces the Metaformer runs: ``RecurrentMixerBlock`` /
``RecurrentMixerLayerd`` (LSTM and GRU kinds, single inner layer) with
the fused stack dispatch (LSTM stacks only, as in the JAX package: a GRU
stack runs block by block), and ``MHAMixerBlock`` / ``MHAMixerLayerd`` on
their masked full-sequence path and their two decode paths: per-block
ring buffers of projected K/V (``caches``) and a shared raw ring
(``shared_raw``). Submodule names
follow the flax tree (``block_i``, ``mixer``, ``mixer_norm``,
``feed_forward``, ``mha_i``). Recurrent stacks return their fresh
states, as in the JAX package (PARITY #1): (h, c) per LSTM block, h per
GRU block.

Dropout, as in the JAX package: an MHA stack hands its rate to every
attention (``TorchMHA``, on the context); a recurrent stack's blocks are
single-layer, so its rate acts only on the dispatch: in training with
dropout > 0 the stack runs block by block (K7 per block on the card,
``_fused_stack``'s JAX gate), not on the fused stack.

Not ported yet: the MLP mixers and the bidirectional and multi-layer
recurrent mixers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.infer.cache import cache_extend
from multimodalreactiongeneration_tpu_torch.nn.attention import TorchMHA
from multimodalreactiongeneration_tpu_torch.nn.basic import (
    FeedForward,
    LayerNorm,
    set_nonlinearity,
)
from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
    MIN_KERNEL_STEPS,
    TorchGRU,
    TorchLSTM,
)
from multimodalreactiongeneration_tpu_torch.ops.mixer_stack import (
    mixer_stack_recurrence,
)


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
    """GRU or LSTM mixer + FFN (reference mixer_block.py:355-507)."""

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
        if kind not in ("gru", "lstm"):
            raise ValueError(f"kind must be gru/lstm, got {kind!r}")
        if num_layers != 1 or bidirectional:
            raise NotImplementedError(
                "the port has the single-layer unidirectional recurrent "
                f"mixers only (kind={kind!r}, num_layers={num_layers}, "
                f"bidirectional={bidirectional})"
            )
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.bottleneck_size = bottleneck_size
        self.use_bias = use_bias
        rnn = TorchLSTM if kind == "lstm" else TorchGRU
        self.mixer = rnn(hidden_size, hidden_size, generator)
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

    cache None, shared_raw None -> full-sequence masked attention;
    cache = one ring buffer per inner MHA layer -> the per-block decode
    path: only the incoming chunk is projected, appended to the ring
    (``attn_mask``, if any, covers the chunk and is scattered onto the
    slots it fills) and attended with the ring's mask;
    shared_raw = (x_full, mask) -> attend a raw ring buffer with folded
    projections (the shared-KV decode path).
    Returns (y, new caches or None)."""

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
        rect_pad_masks: bool = False,
        dropout: float = 0.0,
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
                use_bias=use_bias, rect_pad_masks=rect_pad_masks,
                dropout=dropout,
            ))
        self.mixer_norm = (
            LayerNorm(hidden_size) if residual and residual_layer_norm
            else None
        )
        self.feed_forward = _feed_forward(hidden_size, generator, self)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, shared_raw=None):
        act = set_nonlinearity(self.nonlinearity)
        new_cache = None if cache is None else []
        y = query
        for i in range(self.num_layers):
            mha = getattr(self, f"mha_{i}")
            if shared_raw is not None:
                x_full, smask = shared_raw
                y_att = mha.attend_raw(y, x_full, smask)
            elif cache is None:
                y_att = mha(y, key, value, attn_mask)
            else:
                k_new, v_new = mha.project_kv(key, value)
                c_i, k_full, v_full, mask = cache_extend(
                    cache[i], k_new, v_new, chunk_mask=attn_mask
                )
                new_cache.append(c_i)
                y_att = mha.attend(y, k_full, v_full, mask)
            if act is not None:
                y_att = act(y_att)
            y = y_att
        y = _residual_wrap(y, query, self.residual, self.mixer_norm)
        return self.feed_forward(y), new_cache


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
        """Run the whole block stack through ``mixer_stack_recurrence``
        (the CUDA kernels on the card, its plain version on the CPU;
        differentiable in both; bf16 parameters run its bf16 operand mode
        on the f32 input, and the output and states come back in x's
        dtype, as JAX's); returns None to fall back to the per-block
        modules. Same gate as the JAX package, less its TPU
        backend test: active dropout in training (``dropout == 0 or not
        training``, JAX's ``dropout == 0 or deterministic``) runs the
        blocks one by one."""
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
            and x.shape[1] >= MIN_KERNEL_STEPS
        ):
            return None
        blocks = [getattr(self, f"block_{i}") for i in range(self.num_layerd)]
        # JAX's operand mode: the weights in the parameters' dtype (bf16 in
        # the bf16 step), every other input in f32; b_ih + b_hh is summed
        # in the parameters' dtype, then converted
        mm = blocks[0].mixer.weight_hh_l0.dtype
        mm = mm if mm == torch.bfloat16 else torch.float32

        def st(fn, dtype=torch.float32):
            return torch.stack([fn(b) for b in blocks]).to(dtype).contiguous()

        w_ih_t = st(lambda b: b.mixer.weight_ih_l0.T, mm)
        w_hh_t = st(lambda b: b.mixer.weight_hh_l0.T, mm)
        b_g = st(lambda b: b.mixer.bias_ih_l0 + b.mixer.bias_hh_l0)
        g1 = st(lambda b: b.mixer_norm.weight)
        b1 = st(lambda b: b.mixer_norm.bias)
        w_ff = st(lambda b: b.feed_forward.feedforward.weight.T, mm)
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
        y, (hn, cn) = mixer_stack_recurrence(
            x.float().contiguous(), w_ih_t, b_g, w_hh_t, w_ff, b_ff,
            g1, b1, g2, b2, h0, c0,
        )
        new_states = [(hn[l][None].to(x.dtype), cn[l][None].to(x.dtype))
                      for l in range(n)]
        return y.to(x.dtype), new_states


class MHAMixerLayerd(nn.Module):
    """Self- or cross-attention stack (reference mixer_block.py:846-963).
    ``caches``: per block, None or a list of per-inner-layer rings (the
    per-block decode layout); returns (y, per-block new caches)."""

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
        rect_pad_masks: bool = False,
    ):
        super().__init__()
        self.self_attention = self_attention
        self.num_layerd = num_layerd
        self.dropout = dropout
        for i in range(num_layerd):
            setattr(self, f"block_{i}", MHAMixerBlock(
                hidden_size, generator, num_layers=num_internal_layer,
                num_heads=num_heads, kdim=kdim, vdim=vdim,
                nonlinearity=nonlinearity, residual=residual,
                residual_layer_norm=residual_layer_norm,
                bottleneck_size=bottleneck_size, use_bias=use_bias,
                rect_pad_masks=rect_pad_masks, dropout=dropout,
            ))

    def forward(
        self,
        x: torch.Tensor,
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        caches: Optional[List[Optional[List[Dict[str, Any]]]]] = None,
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
        new_caches = []
        for i in range(self.num_layerd):
            if self.self_attention and i > 0:
                # each stacked block self-attends to its own input
                key = value = query
            query, new_cache = getattr(self, f"block_{i}")(
                query, key, value, attn_mask,
                None if caches is None else caches[i], shared_raw,
            )
            new_caches.append(new_cache)
        return query, new_caches


def build_mixer_layerd(mixer_type: str, configs: Dict[str, Any],
                       generator: torch.Generator) -> nn.Module:
    """MixerLayerdFactory equivalent for the ported mixer kinds."""
    if mixer_type in ("gru", "lstm"):
        return RecurrentMixerLayerd(kind=mixer_type, generator=generator,
                                    **configs)
    if mixer_type == "mha":
        return MHAMixerLayerd(generator=generator, **configs)
    if mixer_type == "mlp":
        raise NotImplementedError(
            "'mlp' mixers are not ported yet (no shipped config runs them)"
        )
    raise ValueError(f"mixer_type must be mlp/gru/lstm/mha, got {mixer_type!r}")
