"""PyTorch port: K5's tensor-core arithmetic, emulated on CPU tensors.

The rect-attention forward kernel (``csrc/rect_attention.cu
rect_attn_fwd``) computes both of its products in 3xTF32 on the tensor
cores, tile by tile with an online softmax. The card tests hold the
kernel to the plain version; this file holds its ARITHMETIC to the plain
version and to the JAX kernel where no card is needed:

  * ``emulate_forward`` repeats the kernel's algorithm in torch f32: each
    operand split into hi = tf32(x) and lo = tf32(x - hi) (10-bit
    mantissas, rounded to nearest with ties away as ``cvt.rna.tf32.f32``),
    the products as lo*hi + hi*lo + hi*hi with FP32 sums; 64-row q tiles
    and 64-key tiles in the kernel's order; per tile the scaled logits,
    the rate-aligned causal and pad-pair masks at -1e30, key columns past
    Lk excluded outright, the running max and sum and the rescaled
    context; a q tile that holds a row whose every key is masked reads
    every key; each row's max and sum are the residuals K6 reads;
  * it matches ``rect_attention_reference`` and the JAX
    ``ops/pallas_rect_attention.py rect_attention`` (Pallas in interpret
    mode) at the shapes of tests/test_torch_port_rect_attention.py, B 2,
    E 64, 2 heads, ~10% padded rows and keys, atol 2e-5 (that file's
    forward bound; the emulation's own distance from the plain version is
    ~1e-6, the three TF32 passes keep FP32's order of error), and its
    residuals match the plain logits' row max and sum (rtol 1e-5);
  * one TF32 pass instead of three drifts by more than 3xTF32 does.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

torch.set_num_threads(1)
FWD_ATOL = 2e-5
B, E, HEADS = 2, 64, 2
TILE_Q, TILE_K = 64, 64
CASES = [(16, 128), (128, 16), (40, 40), (12, 96), (10, 20), (130, 70)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna.tf32.f32: add half of the 13 dropped
    mantissa bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes=3):
    """a @ b from TF32 parts with FP32 sums: three passes (lo*hi + hi*lo
    + hi*hi, the kernel's order) or one (hi*hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def visible(i, lq, lk):
    """Keys visible to query row i (rate-aligned causal)."""
    return min(-(-(i + 1) * lk // lq), lk)


def emulate_forward(heads, q, k, v, q_pad, k_pad, passes=3):
    """K5's forward arithmetic on CPU tensors: (context (B, Lq, E), row
    max (B, H, Lq), row sum (B, H, Lq))."""
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // heads
    scale = 1.0 / math.sqrt(dh)
    out = torch.zeros(b, lq, e)
    m_out = torch.zeros(b, heads, lq)
    l_out = torch.zeros(b, heads, lq)
    for bi in range(b):
        unpadded = torch.nonzero(~k_pad[bi])
        fu = int(unpadded[0]) if len(unpadded) else lk
        for i0 in range(0, lq, TILE_Q):
            rows = range(i0, min(i0 + TILE_Q, lq))
            full = any(bool(q_pad[bi, i]) and fu >= visible(i, lq, lk)
                       for i in rows)
            kend = lk if full else visible(rows[-1], lq, lk)
            lim = torch.tensor([visible(i, lq, lk) for i in rows])
            qp = q_pad[bi, i0:rows[-1] + 1]
            for h in range(heads):
                cols = slice(h * dh, (h + 1) * dh)
                qt = q[bi, i0:rows[-1] + 1, cols]
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                o = torch.zeros(len(rows), dh)
                for j0 in range(0, kend, TILE_K):
                    j1 = min(j0 + TILE_K, lk)  # columns past Lk excluded
                    j = torch.arange(j0, j1)
                    s = product(qt, k[bi, j0:j1, cols].T, passes) * scale
                    masked = (j[None] >= lim[:, None]) | (
                        qp[:, None] & k_pad[bi, j0:j1][None])
                    s = s.masked_fill(masked, K5.NEG_INF)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(dim=1)
                    o = o * alpha[:, None] + product(p, v[bi, j0:j1, cols],
                                                     passes)
                    m = m_new
                out[bi, i0:rows[-1] + 1, cols] = o / l[:, None]
                m_out[bi, h, i0:rows[-1] + 1] = m
                l_out[bi, h, i0:rows[-1] + 1] = l
    return out, m_out, l_out


def _inputs(lq, lk, seed, full_row=False):
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, lq, E), (B, lk, E), (B, lk, E))]
    q_pad = torch.from_numpy(rng.random((B, lq)) < 0.1)
    k_pad = torch.from_numpy(rng.random((B, lk)) < 0.1)
    if full_row:  # row 3 of batch 0 and every key it sees are padding
        q_pad[0, 3] = True
        k_pad[0, :-(-4 * lk // lq)] = True
    return q, k, v, q_pad, k_pad


@pytest.mark.parametrize("lq,lk,full_row", [
    *[(lq, lk, False) for lq, lk in CASES],
    *[(lq, lk, True) for lq, lk in CASES],
])
def test_emulated_tensor_core_forward_matches_plain_and_jax(lq, lk,
                                                            full_row):
    q, k, v, q_pad, k_pad = _inputs(lq, lk, 31 * lq + lk, full_row)
    got, _, _ = emulate_forward(HEADS, q, k, v, q_pad, k_pad)
    want = K5.rect_attention_reference(HEADS, q, k, v, q_pad, k_pad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_ATOL)
    jax_out = jra.rect_attention(
        HEADS, jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(q_pad.numpy()),
        jnp.asarray(k_pad.numpy()))
    if not full_row:  # the JAX kernel averages a full row over padded
        # key columns too (tests/test_torch_port_rect_attention.py)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                                   atol=FWD_ATOL)
    else:
        np.testing.assert_allclose(got[0, 3].numpy(),
                                   v[0].mean(dim=0).numpy(), atol=1e-5)


@pytest.mark.parametrize("lq,lk", [(40, 40), (130, 70), (12, 96)])
def test_emulated_residuals_are_the_row_max_and_sum(lq, lk):
    """The max and sum K6 reads: the masked logits' row max, and the sum
    of exp(logit - max) over the keys the tile loop read."""
    q, k, v, q_pad, k_pad = _inputs(lq, lk, lq + lk, full_row=True)
    _, m, l = emulate_forward(HEADS, q, k, v, q_pad, k_pad)
    dh = E // HEADS
    qs = q.view(B, lq, HEADS, dh).transpose(1, 2)
    ks = k.view(B, lk, HEADS, dh).transpose(1, 2)
    logits = (qs @ ks.transpose(-1, -2)) / math.sqrt(dh)
    logits = logits.masked_fill(
        K5.rect_attention_mask(q_pad, k_pad)[:, None], K5.NEG_INF)
    want_m = logits.max(dim=-1).values
    want_l = torch.exp(logits - want_m[..., None]).sum(dim=-1)
    np.testing.assert_allclose(m.numpy(), want_m.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), want_l.numpy(), rtol=1e-5)


def test_three_tf32_passes_hold_where_one_drifts():
    q, k, v, q_pad, k_pad = _inputs(130, 70, 3)
    q, k = 4 * q, 4 * k  # sharp softmax: logit errors show in the context
    want = K5.rect_attention_reference(HEADS, q, k, v, q_pad, k_pad)
    err = [float((emulate_forward(HEADS, q, k, v, q_pad, k_pad, p)[0]
                  - want).abs().max()) for p in (3, 1)]
    assert err[0] <= FWD_ATOL < err[1]


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = torch.tensor([one + ulp * 0.5, -(one + ulp * 0.5),
                      one + ulp * 0.49, one + ulp * 0.75])
    np.testing.assert_array_equal(
        tf32(x).numpy(), np.array([one + ulp, -(one + ulp), one, one + ulp],
                                  np.float32))
