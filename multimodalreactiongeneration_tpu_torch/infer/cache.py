"""Fixed-shape KV ring buffers for autoregressive decode.

Counterpart of ``multimodalreactiongeneration_tpu/infer/cache.py``:

  * raw rings (``raw_cache_init`` / ``raw_cache_extend``): ONE array of
    pre-projection tokens per other modality, the shared-KV layout;
  * projected rings (``cache_init`` / ``cache_extend``): post-projection
    K and V per (block, integrator or embedding, inner layer), the
    per-block layout. With ``dtype=torch.int8`` they hold symmetric
    per-token int8 codes and the scales ``k_scale`` / ``v_scale``
    ((B, C) f32); consumers get bf16 dequantized views, as in JAX.

A cache is a dict of tensors and ``length``, the count of tokens ever
appended (not clamped to C); slot ``length % C`` is written next.
``length`` is a host ``int`` on the generation paths (the rollout reads
it without a device sync), or a (B,) integer tensor, one ring position a
row, in the serving pool (``infer/serving.py``), where sessions attach
at different steps: JAX gets those per-row positions from ``vmap`` over
batch-1 slots. Masks are True where masked: (1, C) for an int length,
(B, 1, C) for a tensor one, and with a priming ``chunk_mask`` ((..., Lq,
n) bool) that chunk's causality scattered onto the slots just written.

The buffers are written IN PLACE (the old contents are never needed
again, so no copy of a (B, C, D) ring is made per step); the returned
cache shares them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

KVCache = Dict[str, object]
Length = Union[int, torch.Tensor]

_SCALE_EPS = 1e-8  # zero vectors quantize to scale eps, not div-by-zero


def raw_cache_init(
    batch: int,
    capacity: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> KVCache:
    return {
        "x": torch.zeros(batch, capacity, dim, dtype=dtype, device=device),
        "length": 0,
    }


def cache_init(
    batch: int,
    capacity: int,
    kdim: int,
    vdim: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> KVCache:
    vdim = kdim if vdim is None else vdim
    cache = {
        "k": torch.zeros(batch, capacity, kdim, dtype=dtype, device=device),
        "v": torch.zeros(batch, capacity, vdim, dtype=dtype, device=device),
        "length": 0,
    }
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(batch, capacity, device=device)
        cache["v_scale"] = torch.zeros(batch, capacity, device=device)
    return cache


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8: (B, n, D) -> ((B, n, D) int8, (B, n) f32)."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=-1) / 127.0, min=_SCALE_EPS)
    return torch.round(x / scale[..., None]).to(torch.int8), scale


def _check_chunk(n: int, capacity: int, what: str) -> None:
    if n > capacity:
        # modular positions would collide and the ring would keep an
        # arbitrary one of them
        raise ValueError(
            f"cannot extend a capacity-{capacity} {what} with a "
            f"{n}-token chunk; raise max_context_len or shorten the "
            "priming segment"
        )


def _positions(length: Length, n: int, capacity: int, device):
    """Slots of the next n tokens: (n,) for an int length, (B, n) for a
    tensor one."""
    steps = torch.arange(n, device=device)
    if isinstance(length, torch.Tensor):
        return (length.to(device)[:, None] + steps) % capacity
    return (length + steps) % capacity


def _write(buf: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor) -> None:
    """buf[:, pos] = rows in place; per row when pos is (B, n)."""
    if pos.dim() == 1:
        buf[:, pos] = rows.to(buf.dtype)
    else:
        batch = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[batch, pos] = rows.to(buf.dtype)


def _mask(new_len: Length, pos: torch.Tensor,
          capacity: int, chunk_mask: Optional[torch.Tensor], device):
    """True = masked: unwritten slots, and ``chunk_mask`` on the slots
    just written."""
    slots = torch.arange(capacity, device=device)
    if isinstance(new_len, torch.Tensor):
        invalid = slots >= torch.clamp(new_len.to(device), max=capacity)[:, None]
        if chunk_mask is None:
            return invalid[:, None, :]
        lq, n = chunk_mask.shape[-2:]
        batch = invalid.shape[0]
        mask = invalid[:, None, :].expand(batch, lq, capacity).clone()
        mask.scatter_(-1, pos[:, None, :].expand(batch, lq, n),
                      chunk_mask.expand(batch, lq, n))
        return mask
    invalid = slots >= min(new_len, capacity)
    if chunk_mask is None:
        return invalid[None, :]
    mask = invalid.expand(chunk_mask.shape[:-1] + (capacity,)).clone()
    mask[..., pos] = chunk_mask
    return mask


def raw_cache_extend(
    cache: KVCache,
    chunk: torch.Tensor,
    chunk_mask: Optional[torch.Tensor] = None,
) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """Append (B, n, D) raw tokens; return (cache', x_full, mask)."""
    x = cache["x"]
    n, capacity = chunk.shape[1], x.shape[1]
    _check_chunk(n, capacity, "raw cache")
    length = cache["length"]
    pos = _positions(length, n, capacity, x.device)
    _write(x, pos, chunk)
    new_len = length + n
    mask = _mask(new_len, pos, capacity, chunk_mask, x.device)
    return {"x": x, "length": new_len}, x, mask


def cache_extend(
    cache: KVCache,
    key: torch.Tensor,
    value: torch.Tensor,
    chunk_mask: Optional[torch.Tensor] = None,
) -> Tuple[KVCache, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append (B, n, D) projected keys and values; return (cache', k, v,
    mask) with k, v the full (B, C, D) rings (bf16 dequantized views of
    an int8 ring). Slot order does not matter to attention (softmax is
    permutation equivariant over keys), so no unrolling gather is made."""
    k_buf, v_buf = cache["k"], cache["v"]
    n, capacity = key.shape[1], k_buf.shape[1]
    _check_chunk(n, capacity, "KV cache")
    length = cache["length"]
    pos = _positions(length, n, capacity, k_buf.device)
    new_cache = {"k": k_buf, "v": v_buf}
    if k_buf.dtype == torch.int8:
        qk, sk = _quantize(key)
        qv, sv = _quantize(value)
        for name, rows in (("k", qk), ("v", qv), ("k_scale", sk),
                           ("v_scale", sv)):
            _write(cache[name], pos, rows)
            new_cache[name] = cache[name]
        bf16 = torch.bfloat16
        k_out = k_buf.to(bf16) * cache["k_scale"][..., None].to(bf16)
        v_out = v_buf.to(bf16) * cache["v_scale"][..., None].to(bf16)
    else:
        _write(k_buf, pos, key)
        _write(v_buf, pos, value)
        k_out, v_out = k_buf, v_buf
    new_len = length + n
    new_cache["length"] = new_len
    mask = _mask(new_len, pos, capacity, chunk_mask, k_buf.device)
    return new_cache, k_out, v_out, mask
