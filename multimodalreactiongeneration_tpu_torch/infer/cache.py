"""Raw ring buffers for the shared-KV decode layout.

Counterpart of ``raw_cache_init`` / ``raw_cache_extend`` in
``multimodalreactiongeneration_tpu/infer/cache.py``. A cache is a dict
``{"x": (B, C, D) tensor, "length": int}``; ``length`` counts every token
ever appended (not clamped to C), and slot ``length % C`` is written
next. The per-block projected caches and int8 caches are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

RawCache = Dict[str, object]


def raw_cache_init(
    batch: int,
    capacity: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> RawCache:
    return {
        "x": torch.zeros(batch, capacity, dim, dtype=dtype, device=device),
        "length": 0,
    }


def raw_cache_extend(
    cache: RawCache,
    chunk: torch.Tensor,
    chunk_mask: Optional[torch.Tensor] = None,
) -> Tuple[RawCache, torch.Tensor, torch.Tensor]:
    """Append (B, n, D) tokens; return (cache', x_full, mask).

    The buffer is written IN PLACE (the old contents are never needed
    again, so no copy of the (B, C, D) ring is made per step);
    ``cache'`` shares it. ``mask`` (True = masked) hides unwritten slots;
    a ``chunk_mask`` ((..., Lq, n) bool) scatters intra-chunk causality
    onto the just-written slots when priming with a multi-token chunk.
    """
    x = cache["x"]
    n = chunk.shape[1]
    capacity = x.shape[1]
    if n > capacity:
        raise ValueError(
            f"cannot extend a capacity-{capacity} raw cache with a "
            f"{n}-token chunk; raise max_context_len or shorten the "
            "priming segment"
        )
    length = int(cache["length"])
    pos = (length + torch.arange(n, device=x.device)) % capacity
    x[:, pos] = chunk.to(x.dtype)
    new_len = length + n
    invalid = torch.arange(capacity, device=x.device) >= min(new_len, capacity)
    if chunk_mask is None:
        mask = invalid[None, :]
    else:
        mask = invalid.expand(chunk_mask.shape[:-1] + (capacity,)).clone()
        mask[..., pos] = chunk_mask
    return {"x": x, "length": new_len}, x, mask
