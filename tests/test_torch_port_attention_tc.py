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
  * one TF32 pass instead of three drifts by more than 3xTF32 does;
  * ``emulate_backward`` repeats the backward kernel's algorithm
    (``rect_attn_bwd_kv`` and ``rect_attn_bwd_dq_sum``) the same way: one
    pass per 64-key block over the 16-row q tiles that see its keys, P
    from the emulated forward's max and sum, dS zero where the mask is
    set, S and dP once per (q tile, key block) pair, all five products in
    3xTF32; a q tile before the block's first seeing row is visited only
    if it holds a row whose every key is masked, for dV alone; each key
    block's partial dS K goes to the rows that see its keys, and dQ sums
    them in key-block order. It matches ``rect_attention_backward_
    reference`` and the JAX gradients of ``rect_attention`` (interpret
    mode) at atol 2e-4, the gradient bound of
    tests/test_torch_port_rect_attention.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5
from tests.tf32_emulation import product, tf32

torch.set_num_threads(1)
FWD_ATOL, GRAD_ATOL = 2e-5, 2e-4
B, E, HEADS = 2, 64, 2
TILE_Q, TILE_K = 64, 64
BWD_KEYS, BWD_ROWS = 64, 16  # the backward's key block and q rows a step
CASES = [(16, 128), (128, 16), (40, 40), (12, 96), (10, 20), (130, 70)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


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


def emulate_backward(heads, q, k, v, q_pad, k_pad, g):
    """The backward kernel's arithmetic on CPU tensors, from the emulated
    forward's context, max and sum: (dq, dk, dv)."""
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // heads
    scale = 1.0 / math.sqrt(dh)
    out, m_all, l_all = emulate_forward(heads, q, k, v, q_pad, k_pad)
    dq, dk, dv = torch.zeros(b, lq, e), torch.zeros(b, lk, e), torch.zeros(
        b, lk, e)
    nqt = -(-lq // BWD_ROWS)
    for bi in range(b):
        unpadded = torch.nonzero(~k_pad[bi])
        fu = int(unpadded[0]) if len(unpadded) else lk
        full_tiles = {i // BWD_ROWS for i in range(lq)
                      if bool(q_pad[bi, i]) and fu >= visible(i, lq, lk)}
        for h in range(heads):
            cols = slice(h * dh, (h + 1) * dh)
            d_row = (g[bi, :, cols] * out[bi, :, cols]).sum(dim=1)
            m, l = m_all[bi, h], l_all[bi, h]
            partials = []
            for j0 in range(0, lk, BWD_KEYS):
                j1 = min(j0 + BWD_KEYS, lk)  # key columns past Lk excluded
                j = torch.arange(j0, j1)
                r0 = j0 * lq // lk  # the first row that sees key j0
                kt, vt = k[bi, j0:j1, cols], v[bi, j0:j1, cols]
                dkt, dvt = torch.zeros(j1 - j0, dh), torch.zeros(j1 - j0, dh)
                part = torch.zeros(lq, dh)
                for t in range(nqt):
                    vis = t >= r0 // BWD_ROWS
                    if not vis and t not in full_tiles:
                        continue
                    i0, i1 = t * BWD_ROWS, min((t + 1) * BWD_ROWS, lq)
                    i = torch.arange(i0, i1)
                    qt, gt = q[bi, i0:i1, cols], g[bi, i0:i1, cols]
                    masked = (j[:, None] * lq >= (i[None] + 1) * lk) | (
                        k_pad[bi, j0:j1][:, None] & q_pad[bi, i0:i1][None])
                    if vis:  # S^T and dP^T, once per (q tile, key block)
                        st, dpt = product(kt, qt.T), product(vt, gt.T)
                    else:  # every pair masked: P alone, for dV
                        st = dpt = torch.zeros(j1 - j0, i1 - i0)
                    x = torch.where(masked, K5.NEG_INF, st * scale)
                    p = torch.exp(x - m[i0:i1][None]) * (1.0 / l[i0:i1])[None]
                    ds = torch.where(masked, 0.0, p * (dpt - d_row[i0:i1][None]))
                    dvt += product(p, gt)
                    if vis:
                        dkt += product(ds, qt)
                        part[i0:i1] = product(ds.T, kt)
                dk[bi, j0:j1, cols] = dkt * scale
                dv[bi, j0:j1, cols] = dvt
                partials.append((r0, part))
            acc = torch.zeros(lq, dh)
            for r0, part in partials:  # key-block order
                acc[r0:] += part[r0:]
            dq[bi, :, cols] = acc * scale
    return dq, dk, dv


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


def _full_rows(q_pad, k_pad, rows, lq, lk):
    """Rows ``rows`` of batch 0 padding and every key they see padding,
    the rest of batch 0 unpadded."""
    q_pad[0] = False
    q_pad[0, rows] = True
    k_pad[0] = False
    k_pad[0, :visible(max(rows), lq, lk)] = True


@pytest.mark.parametrize("lq,lk,full", [
    (40, 40, ()),          # one key block, two q tiles
    (130, 70, ()),         # Lq > Lk, both ragged
    (12, 96, ()),          # less than one q tile, two key blocks
    (128, 16, (3,)),       # a full row, one key block
    (96, 256, (3,)),       # later key blocks visit tile 0 for dV only
    (100, 200, (3, 9, 40)),  # full rows in two tiles beside normal rows
])
def test_emulated_tensor_core_backward_matches_plain_and_jax(lq, lk, full):
    q, k, v, q_pad, k_pad = _inputs(lq, lk, 7 * lq + lk)
    if full:
        _full_rows(q_pad, k_pad, list(full), lq, lk)
    g = torch.from_numpy(np.random.default_rng(lq + 3 * lk).standard_normal(
        (B, lq, E)).astype(np.float32))
    got = emulate_backward(HEADS, q, k, v, q_pad, k_pad, g)
    want = K5.rect_attention_backward_reference(HEADS, q, k, v, q_pad, k_pad,
                                                g)
    for x, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(x.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   err_msg=f"d{name} vs plain")

    def f(q, k, v):
        return jra.rect_attention(HEADS, q, k, v, jnp.asarray(q_pad.numpy()),
                                  jnp.asarray(k_pad.numpy()))

    _, vjp = jax.vjp(f, *[jnp.asarray(x.numpy()) for x in (q, k, v)])
    jq, jk, jv = [np.asarray(w) for w in vjp(jnp.asarray(g.numpy()))]
    x = [t.numpy() for t in got]
    # the JAX kernel does not zero dS where the mask is set, so a full
    # row (constant logits) gives it a nonzero dq and adds to dk of its
    # batch row (ROADMAP queue C); those entries are held to plain only
    rows = np.ones(lq, bool)
    rows[list(full)] = False
    keep_b = 1 if full else 0
    for got_x, want_x, name in ((x[0][0, rows], jq[0, rows], "q, batch 0"),
                                (x[0][1:], jq[1:], "q"),
                                (x[1][keep_b:], jk[keep_b:], "k"),
                                (x[2], jv, "v")):
        np.testing.assert_allclose(got_x, want_x, atol=GRAD_ATOL,
                                   err_msg=f"d{name} vs JAX")
