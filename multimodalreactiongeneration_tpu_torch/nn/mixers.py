"""MLP, recurrent and attention mixer blocks and their layered stacks.

Counterpart of ``multimodalreactiongeneration_tpu/nn/mixers.py``:
``MLPMixerBlock`` / ``MLPMixerLayerd`` (Dense layers ``input``,
``hidden_{i}``, ``output``; no state: a stack returns (x, None)),
``RecurrentMixerBlock`` / ``RecurrentMixerLayerd`` (LSTM and GRU kinds,
any number of inner layers, one or two directions: bidirectional halves
the hidden size so that the concatenated output is ``hidden_size``; the
inner ``TorchLSTM`` / ``TorchGRU`` takes the stack's dropout between its
layers) with the fused stack dispatch (single-layer unidirectional LSTM
blocks only, as in the JAX package: other kinds run block by block) and
the layerd's optional ``input_projection`` / ``output_projection``
Dense layers, and ``MHAMixerBlock`` / ``MHAMixerLayerd`` on their masked
full-sequence path and their two decode paths: per-block ring buffers of
projected K/V (``caches``) and a shared raw ring (``shared_raw``).
Submodule names follow the flax tree (``block_i``, ``mixer``,
``mixer_norm``, ``feed_forward``, ``mha_i``). Recurrent stacks return
their fresh states, as in the JAX package (PARITY #1): per block the
inner module's (h, c) for an LSTM, h for a GRU, each (layers *
directions, B, H).

Dropout, as in the JAX package: an MHA stack hands its rate to every
attention (``TorchMHA``, on the context); a recurrent stack hands it to
each block's inner recurrence, where it acts between inner layers, and
in training with dropout > 0 the stack runs block by block (K7 per block
on the card, ``_fused_stack``'s JAX gate), not on the fused stack.
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
    dense,
    set_nonlinearity,
)
from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
    MIN_KERNEL_STEPS,
    TorchGRU,
    TorchLSTM,
)
from multimodalreactiongeneration_tpu_torch.ops.mixer_stack import (
    kernel_refusal as stack_refusal,
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


class MLPMixerBlock(nn.Module):
    """MLP mixer + FFN (reference mixer_block.py:114-166, 308-352)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        num_layer: int = 1,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.num_layer = num_layer
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.bottleneck_size = bottleneck_size
        self.use_bias = use_bias
        self.input = dense(hidden_size, hidden_size, generator, use_bias)
        for i in range(1, num_layer):
            setattr(self, f"hidden_{i}",
                    dense(hidden_size, hidden_size, generator, use_bias))
        self.output = dense(hidden_size, hidden_size, generator, use_bias)
        self.mixer_norm = (
            LayerNorm(hidden_size) if residual and residual_layer_norm
            else None
        )
        self.feed_forward = _feed_forward(hidden_size, generator, self)

    def forward(self, x):
        act = set_nonlinearity(self.nonlinearity)
        y = self.input(x)
        if act is not None:
            y = act(y)
        for i in range(1, self.num_layer):
            y = getattr(self, f"hidden_{i}")(y)
            if act is not None:
                y = act(y)
        y = _residual_wrap(self.output(y), x, self.residual, self.mixer_norm)
        return self.feed_forward(y)


class RecurrentMixerBlock(nn.Module):
    """GRU or LSTM mixer + FFN (reference mixer_block.py:355-507).
    Bidirectional halves the hidden size so the concatenation matches
    ``hidden_size`` (mixer_block.py:185-190, 228-233)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        kind: str = "lstm",
        num_layers: int = 1,
        dropout: float = 0.0,
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
        hidden = hidden_size
        if bidirectional:
            if hidden % 2:
                raise ValueError("hidden_size must be even when bidirectional")
            hidden //= 2
        self.nonlinearity = nonlinearity
        self.residual = residual
        self.residual_layer_norm = residual_layer_norm
        self.bottleneck_size = bottleneck_size
        self.use_bias = use_bias
        rnn = TorchLSTM if kind == "lstm" else TorchGRU
        self.mixer = rnn(hidden_size, hidden, generator, num_layers=num_layers,
                         bidirectional=bidirectional, dropout=dropout)
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


def _projections(module, hidden_size, generator, input_projection_size,
                 output_projection_size):
    """A layerd's optional Dense layers: ``input_projection`` from
    ``input_projection_size`` features to ``hidden_size`` (flax infers
    its input size from x; here it is the input's feature size) and
    ``output_projection`` from ``hidden_size`` to
    ``output_projection_size``; both with bias, as flax's Dense."""
    module.input_projection = (
        None if input_projection_size is None
        else dense(input_projection_size, hidden_size, generator))
    module.output_projection = (
        None if output_projection_size is None
        else dense(hidden_size, output_projection_size, generator))


def _project(layer, x):
    return x if layer is None else layer(x)


class MLPMixerLayerd(nn.Module):
    """Stack of MLP mixer blocks; stateless: returns (y, None)."""

    def __init__(
        self,
        hidden_size: int,
        generator: torch.Generator,
        num_layerd: int = 1,
        num_internal_layer: int = 1,
        input_projection_size: Optional[int] = None,
        output_projection_size: Optional[int] = None,
        nonlinearity: Optional[str] = None,
        residual: bool = False,
        residual_layer_norm: bool = False,
        bottleneck_size: Optional[int] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.num_layerd = num_layerd
        _projections(self, hidden_size, generator, input_projection_size,
                     output_projection_size)
        for i in range(num_layerd):
            setattr(self, f"block_{i}", MLPMixerBlock(
                hidden_size, generator, num_layer=num_internal_layer,
                nonlinearity=nonlinearity, residual=residual,
                residual_layer_norm=residual_layer_norm,
                bottleneck_size=bottleneck_size, use_bias=use_bias,
            ))

    def forward(self, x, hx=None):
        x = _project(self.input_projection, x)
        for i in range(self.num_layerd):
            x = getattr(self, f"block_{i}")(x)
        return _project(self.output_projection, x), None


def require_stack_kernel(device_type: str, layers: int, steps: int,
                         hidden: int) -> None:
    """Where a stack goes to ``mixer_stack_recurrence``: on CUDA, raise
    (naming K1/K3/K4) for a hidden size its kernels do not take; on the
    CPU the plain version takes any."""
    why = stack_refusal(hidden)
    if why is not None and device_type == "cuda":
        raise NotImplementedError(
            f"a {layers}-block LSTM mixer stack over {steps} steps needs the "
            f"encoder-stack kernels (K1/K3/K4), which do not take {why}")


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
        input_projection_size: Optional[int] = None,
        output_projection_size: Optional[int] = None,
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
        _projections(self, hidden_size, generator, input_projection_size,
                     output_projection_size)
        for i in range(num_layerd):
            setattr(self, f"block_{i}", RecurrentMixerBlock(
                hidden_size, generator, kind=kind,
                num_layers=num_internal_layer, dropout=dropout,
                bidirectional=bidirectional, nonlinearity=nonlinearity,
                residual=residual, residual_layer_norm=residual_layer_norm,
                bottleneck_size=bottleneck_size, use_bias=use_bias,
            ))

    def forward(self, x, hx: Optional[List[Any]] = None):
        x = _project(self.input_projection, x)
        fused = self._fused_stack(x, hx)
        if fused is not None:
            y, new_states = fused
            return _project(self.output_projection, y), new_states
        new_states = []
        for i in range(self.num_layerd):
            x, bhx = getattr(self, f"block_{i}")(
                x, None if hx is None else hx[i]
            )
            new_states.append(bhx)
        return _project(self.output_projection, x), new_states

    def _fused_stack(self, x, hx):
        """Run the whole block stack through ``mixer_stack_recurrence``
        (the CUDA kernels on the card, its plain version on the CPU;
        differentiable in both; bf16 parameters run its bf16 operand mode
        on the f32 input, and the output and states come back in x's
        dtype, as JAX's); returns None to fall back to the per-block
        modules. Same gate as the JAX package, less its TPU
        backend test: active dropout in training (``dropout == 0 or not
        training``, JAX's ``dropout == 0 or deterministic``) runs the
        blocks one by one. JAX's stack kernel takes any hidden size; on
        CUDA a size the port's K1/K3/K4 do not take (past 512) raises
        rather than run the blocks where JAX runs its kernel."""
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
        require_stack_kernel(x.device.type, self.num_layerd, x.shape[1],
                             self.hidden_size)
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
    """MixerLayerdFactory equivalent (reference mixer_block.py:993-1017)."""
    if mixer_type in ("gru", "lstm"):
        return RecurrentMixerLayerd(kind=mixer_type, generator=generator,
                                    **configs)
    if mixer_type == "mha":
        return MHAMixerLayerd(generator=generator, **configs)
    if mixer_type == "mlp":
        return MLPMixerLayerd(generator=generator, **configs)
    raise ValueError(f"mixer_type must be mlp/gru/lstm/mha, got {mixer_type!r}")
