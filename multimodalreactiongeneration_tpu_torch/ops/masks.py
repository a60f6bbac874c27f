"""Attention masks for cross-rate multimodal attention (True = masked).

Counterpart of ``multimodalreactiongeneration_tpu/ops/masks.py``: key j
of length S is masked for query i of length L iff ``j*L >= (i+1)*S``;
padding masks only (pad query, pad key) pairs.
"""

from __future__ import annotations

from typing import Optional

import torch

PADDING_VALUE = -100.0


def rectangular_causal_mask(
    q_len: int, k_len: int, device: Optional[torch.device] = None
) -> torch.Tensor:
    """(q_len, k_len) bool mask; one length must divide the other."""
    if q_len % k_len != 0 and k_len % q_len != 0:
        raise ValueError(
            f"lengths must be rate-aligned: q_len={q_len}, k_len={k_len}"
        )
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    return j * q_len >= (i + 1) * k_len


def padding_indicator(
    x: torch.Tensor, padding_value: float = PADDING_VALUE
) -> torch.Tensor:
    """(B, T, D) -> (B, T) bool; True where the first channel is padding."""
    return x[:, :, 0] == padding_value


def merged_attention_mask(
    q_modal: torch.Tensor,
    k_modal: torch.Tensor,
    padding_value: float = PADDING_VALUE,
) -> torch.Tensor:
    """(B, Lq, Lk) bool: rectangular causal OR pad-pair mask."""
    causal = rectangular_causal_mask(
        q_modal.shape[1], k_modal.shape[1], device=q_modal.device
    )
    q_pad = padding_indicator(q_modal, padding_value)
    k_pad = padding_indicator(k_modal, padding_value)
    return causal[None] | (q_pad[:, :, None] & k_pad[:, None, :])
