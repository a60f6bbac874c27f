"""Multi-head attention with torch-parity layout and finite masking.

Counterpart of ``multimodalreactiongeneration_tpu/nn/attention.py``:

  * projections are stored in torch layout (out, in) under
    nn.MultiheadAttention's names (``q_proj_weight`` ...);
  * masks are bool (True = masked) at rank 2/3/4;
  * masked logits get the finite -1e30, so a fully masked row gives a
    uniform average instead of torch's NaN (PARITY #4); stock
    ``nn.MultiheadAttention`` / ``scaled_dot_product_attention`` are not
    used for that reason;
  * ``attend_raw`` attends RAW key=value tokens with the K/V projections
    folded into the query and output sides (the shared-KV decode
    layout): the k-bias cancels in softmax, the v-bias is restored
    additively because the weights sum to 1.

With ``dropout`` > 0, training drops elements of the attention context
before the output projection, at the JAX package's three sites (the rect
route's (B, L, E) context, the plain route's and ``attend_raw``'s (B, H,
L, Dh) one): torch drops the attention weights instead; the JAX package
drops the context, and the port follows it.

Operand rule of the bf16 decode caches: a bf16 key stream meets a query
rounded to bf16, products accumulate in f32, and the softmax weights are
rounded to the stream's dtype before the context sum.

A module built with ``rect_pad_masks=True`` (the Metaformer's
integrators) declares that every rank-3 mask its ``forward`` receives is
a rect-causal | pad-pair mask (``ops/masks.py merged_attention_mask``).
``attend`` then rebuilds the pad vectors from the mask and runs
``ops/rect_attention.py rect_attention`` (the K5/K6 kernels on the card,
the plain version on the CPU) under the JAX package's conditions: rank-3
mask, batch leading, one length dividing the other. The route is always
on, as on the TPU; the decode paths (``attend_raw``, the rollout) do not
take it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalreactiongeneration_tpu_torch.nn.basic import dropout, matmul
from multimodalreactiongeneration_tpu_torch.ops.masks import (
    rectangular_causal_mask,
)
from multimodalreactiongeneration_tpu_torch.ops.rect_attention import (
    rect_attention,
)

NEG_INF = -1e30


def _broadcast_mask(
    attn_mask: Optional[torch.Tensor],
    batch: int,
    heads: int,
    q_len: int,
    k_len: int,
) -> Optional[torch.Tensor]:
    """Accept (L,S), (B,L,S), (B*H,L,S) or (B,H,L,S) -> (B,H,L,S)-broadcastable."""
    if attn_mask is None:
        return None
    if attn_mask.dim() == 2:
        return attn_mask[None, None]
    if attn_mask.dim() == 3:
        if attn_mask.shape[0] == batch * heads:
            return attn_mask.reshape(batch, heads, q_len, k_len)
        return attn_mask[:, None]
    return attn_mask


def _as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the operand dtype, compute in f32 (f32 accumulation)."""
    return x.to(dtype).float()


def scaled_dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B,H,L,Dh) x (B,H,S,Dh) x (B,H,S,Dh) -> (B,H,L,Dh) f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = _as_operand(q, k.dtype)
    logits = q @ k.float().transpose(-1, -2) * scale
    if mask is not None:
        logits = logits.masked_fill(mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return _as_operand(weights, v.dtype) @ v.float()


def _xavier_uniform(shape, generator: torch.Generator) -> nn.Parameter:
    fan_out, fan_in = shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(*shape)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


class TorchMHA(nn.Module):
    """torch.nn.MultiheadAttention(batch_first=True) equivalent;
    ``rect_pad_masks`` as the module docstring says."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        generator: torch.Generator,
        kdim: Optional[int] = None,
        vdim: Optional[int] = None,
        use_bias: bool = True,
        rect_pad_masks: bool = False,
        dropout: float = 0.0,
    ):
        super().__init__()
        e = embed_dim
        self.dropout = dropout
        self.rect_pad_masks = rect_pad_masks
        self.embed_dim = e
        self.num_heads = num_heads
        self.kdim = kdim if kdim is not None else e
        self.vdim = vdim if vdim is not None else e
        self.use_bias = use_bias
        self.q_proj_weight = _xavier_uniform((e, e), generator)
        self.k_proj_weight = _xavier_uniform((e, self.kdim), generator)
        self.v_proj_weight = _xavier_uniform((e, self.vdim), generator)
        # out_proj keeps nn.Linear's default U(-1/sqrt(fan_in), ...)
        w = torch.empty(e, e)
        w.uniform_(-1.0 / math.sqrt(e), 1.0 / math.sqrt(e),
                   generator=generator)
        self.out_proj_weight = nn.Parameter(w)
        if use_bias:
            self.q_proj_bias = nn.Parameter(torch.zeros(e))
            self.k_proj_bias = nn.Parameter(torch.zeros(e))
            self.v_proj_bias = nn.Parameter(torch.zeros(e))
            self.out_proj_bias = nn.Parameter(torch.zeros(e))

    def _bias(self, name: str):
        return getattr(self, name) if self.use_bias else 0.0

    def project_kv(
        self, key: torch.Tensor, value: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,S,kdim/vdim) -> projected (B,S,E) pair."""
        k = matmul(key, self.k_proj_weight.T) + self._bias("k_proj_bias")
        v = matmul(value, self.v_proj_weight.T) + self._bias("v_proj_bias")
        return k, v

    def attend(
        self,
        query: torch.Tensor,
        k_proj: torch.Tensor,
        v_proj: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        rect_pad_hint: bool = False,
    ) -> torch.Tensor:
        """Attention over already-projected K/V (both (B,S,E)).
        ``rect_pad_hint`` (set by ``forward`` on ``rect_pad_masks``
        modules) routes rate-aligned rank-3 masks to ``rect_attention``."""
        e, h = self.embed_dim, self.num_heads
        dh = e // h
        batch, q_len = query.shape[0], query.shape[1]
        k_len = k_proj.shape[1]
        q = matmul(query, self.q_proj_weight.T) + self._bias("q_proj_bias")
        if (
            rect_pad_hint
            and attn_mask is not None
            and attn_mask.dim() == 3
            and attn_mask.shape[0] == batch
            and (q_len % k_len == 0 or k_len % q_len == 0)
        ):
            # the pad vectors back out of the merged mask: exact for masks
            # built by merged_attention_mask (its pad part is an outer
            # product of the indicators)
            pp = attn_mask & ~rectangular_causal_mask(
                q_len, k_len, attn_mask.device)[None]
            ctx = rect_attention(h, q.contiguous(), k_proj.contiguous(),
                                 v_proj.contiguous(), pp.any(dim=2),
                                 pp.any(dim=1))
            ctx = dropout(ctx, self.dropout, self.training)
            return (matmul(ctx, self.out_proj_weight.T)
                    + self._bias("out_proj_bias"))
        q = q.reshape(batch, q_len, h, dh).transpose(1, 2)
        k = k_proj.reshape(batch, k_len, h, dh).transpose(1, 2)
        v = v_proj.reshape(batch, k_len, h, dh).transpose(1, 2)
        mask = _broadcast_mask(attn_mask, batch, h, q_len, k_len)
        ctx = dropout(scaled_dot_attention(q, k, v, mask), self.dropout,
                      self.training)
        ctx = ctx.transpose(1, 2).reshape(batch, q_len, e)
        return (matmul(ctx, self.out_proj_weight.T)
                + self._bias("out_proj_bias"))

    def attend_raw(
        self,
        query: torch.Tensor,
        raw: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Attention over RAW key=value tokens (B, S, kdim), K/V
        projections folded out of the S-length stream."""
        e, h = self.embed_dim, self.num_heads
        dh = e // h
        kdim = raw.shape[-1]
        if self.vdim != self.kdim:
            raise ValueError(
                "attend_raw requires kdim == vdim (key and value are "
                f"the same raw stream); got kdim={self.kdim} "
                f"vdim={self.vdim}"
            )
        batch, q_len, s_len = query.shape[0], query.shape[1], raw.shape[1]
        q = query @ self.q_proj_weight.T + self._bias("q_proj_bias")
        qh = q.reshape(batch, q_len, h, dh).transpose(1, 2)
        wk_h = self.k_proj_weight.reshape(h, dh, kdim)
        q_fold = torch.einsum("bhld,hdk->bhlk", qh, wk_h)
        logits = torch.einsum(
            "bhlk,bsk->bhls", _as_operand(q_fold, raw.dtype), raw.float()
        ) * (1.0 / math.sqrt(dh))
        mask = _broadcast_mask(attn_mask, batch, h, q_len, s_len)
        if mask is not None:
            logits = logits.masked_fill(mask, NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        ctx_pre = torch.einsum(
            "bhls,bsk->bhlk", _as_operand(weights, raw.dtype), raw.float()
        )
        wv_h = self.v_proj_weight.reshape(h, dh, kdim)
        ctx = torch.einsum("bhlk,hdk->bhld", ctx_pre, wv_h)
        if self.use_bias:
            ctx = ctx + self.v_proj_bias.reshape(h, 1, dh)[None]
        ctx = dropout(ctx, self.dropout, self.training)
        ctx = ctx.transpose(1, 2).reshape(batch, q_len, e)
        return ctx @ self.out_proj_weight.T + self._bias("out_proj_bias")

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        k, v = self.project_kv(key, value)
        return self.attend(query, k, v, attn_mask,
                           rect_pad_hint=self.rect_pad_masks)
