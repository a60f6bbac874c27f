"""PyTorch port: the streamed schedule of K5/K6's bf16 mode, emulated on
CPU tensors.

``csrc/attention_bf16.cu`` computes JAX's bf16 rect attention
(``ops/pallas_rect_attention.py`` on bf16 q, k, v) without any (Lq, Lk)
plane. The card tests hold the kernels to the plain bf16 version; this
file holds their ARITHMETIC ORDER to the JAX kernel and to the plain bf16
version where no card is needed:

  * ``emulate_forward`` repeats K5 bf16 in torch f32 on the bf16 values:
    64-row q tiles, 64-key tiles (columns past Lk excluded outright, a
    tile holding a fully masked row reads every key, the others stop at
    the causal horizon) dealt in turn to ``KEY_GROUPS`` key groups; pass A
    keeps each group's running max and sum, merged in group order into
    the row's m and l; pass B recomputes the logits, forms w = exp(s - m)
    / l, rounds the normalized w to bf16, each group accumulates bf16(w) V
    over its tiles, and the groups' contexts are added in group order;
  * ``emulate_backward`` repeats K6 bf16: JAX's D = rowsum(dw o w) in a
    pre-pass over the same tiles (dw = bf16(g) bf16(v)^T, w from m and l;
    the kernel's route (a)); then one pass per 64-key block over the 16-row
    q tiles that see its keys (and, before them, the tiles holding a
    fully masked row, for dV alone), dS = w (dW - D) zero where masked
    and rounded to bf16, dV += bf16(w)^T bf16(g), dK += bf16(dS)^T Q,
    each block's partial dS K summed into dQ in key-block order; each
    gradient rounded to bf16 once;
  * both hold to JAX's bf16 kernel (Pallas in interpret mode, eager, as
    tests/test_torch_port_bf16_flagship.py runs it) and to
    ``rect_attention_bf16_reference``: the context within
    ``BF16_ATTN_TOL`` (a normalized weight on a bf16 rounding boundary
    may round the other way: 2^-8 of a weight times a value; the card
    tests' and chip_smoke.py's bound), the bf16 gradients within
    ``BF16_REL`` of their largest magnitude (tests/test_torch_port_bf16_
    flagship.py), and the distance test of chip_smoke.py (the context's
    mean error at most ``BF16_MODE_FRAC`` of the plain f32 version's mean
    distance from the plain bf16 one). Observed: the context within
    1.8e-7 of both (8.5e-5 with fully masked rows), the gradients within
    5e-4 of the largest where JAX's kernel is comparable, distances below
    1e-3; the kernel's exp and reciprocal (a few FP32 ulps off) and its
    other sum orders move a weight across a bf16 rounding boundary now and
    then, which the same bounds cover on the card;
  * the control: the f32 flash kernels' rounding on bf16 operands
    (``flash_bf16``, as ``tools/flash_bf16_probe.py`` writes it: the
    UNNORMALIZED weights rounded, D = rowsum(bf16(g) o context)) fails
    that distance test (1.33 at B2 x 252 x 2016, where the emulated
    schedule reads 6e-4), so the test tells the two designs apart.

Cases: tests/test_torch_port_rect_attention.py's (B 2, E 64, 2 heads:
head dim 32; Lq > Lk; key counts not multiples of 64), a fully masked
row, head dim 64 over several q tiles and key blocks.
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
from multimodalreactiongeneration_tpu_torch.ops.lstm_bf16 import round_bf16
from tests.test_torch_port_rect_attention import CASES

torch.set_num_threads(1)
BF = torch.bfloat16
TILE_Q, TILE_K = 64, 64  # the forward's q rows and key tile
KEY_GROUPS = 2  # the forward's key groups (csrc/attention_bf16.cu)
BWD_KEYS, BWD_ROWS = 64, 16  # the backward's key block and q rows a step
BF16_ATTN_TOL = 1e-2  # chip_smoke.py BF16_ATTN_TOL[0]
BF16_REL = 1e-2  # tests/test_torch_port_bf16_flagship.py
BF16_MODE_FRAC = 0.25  # chip_smoke.py's distance test
# (Lq, Lk, E, heads, fully masked rows of batch 0)
SCHEDULE_CASES = [
    *[(lq, lk, 64, 2, ()) for lq, lk in CASES],
    (130, 200, 128, 2, ()),    # head dim 64, three q tiles, four key blocks
    (96, 256, 64, 2, (3,)),    # a full row: later key blocks visit its tile
    (100, 200, 128, 2, (3, 9, 40)),  # full rows in two tiles, head dim 64
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def visible(i, lq, lk):
    """Keys visible to query row i (rate-aligned causal)."""
    return min(-(-(i + 1) * lk // lq), lk)


def _first_unpadded(k_pad_row, lk):
    unpadded = torch.nonzero(~k_pad_row)
    return int(unpadded[0]) if len(unpadded) else lk


def _tile_logits(qt, kt, j0, rows, lq, lk, qp, kp, scale):
    """A tile's scaled logits, -1e30 where masked (keys j0.. of kt)."""
    j = torch.arange(j0, j0 + kt.shape[0])
    lim = torch.tensor([visible(i, lq, lk) for i in rows])
    masked = (j[None] >= lim[:, None]) | (qp[:, None] & kp[None])
    return (qt @ kt.T * scale).masked_fill(masked, K5.NEG_INF)


def emulate_forward(heads, q, k, v, q_pad, k_pad):
    """K5 bf16's arithmetic: (context (B, Lq, E) f32, row max and row sum
    (B, H, Lq)); q, k, v bf16."""
    q, k, v = q.float(), k.float(), v.float()
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // heads
    scale = 1.0 / math.sqrt(dh)
    out = torch.zeros(b, lq, e)
    m_out, l_out = torch.zeros(b, heads, lq), torch.zeros(b, heads, lq)
    for bi in range(b):
        fu = _first_unpadded(k_pad[bi], lk)
        for i0 in range(0, lq, TILE_Q):
            rows = range(i0, min(i0 + TILE_Q, lq))
            full = any(bool(q_pad[bi, i]) and fu >= visible(i, lq, lk)
                       for i in rows)
            kend = lk if full else visible(rows[-1], lq, lk)
            qp = q_pad[bi, rows[0]:rows[-1] + 1]
            for h in range(heads):
                cols = slice(h * dh, (h + 1) * dh)
                qt = q[bi, rows[0]:rows[-1] + 1, cols]

                def logits(j0):
                    j1 = min(j0 + TILE_K, lk)  # columns past Lk excluded
                    return _tile_logits(qt, k[bi, j0:j1, cols], j0, rows, lq,
                                        lk, qp, k_pad[bi, j0:j1], scale), j1

                groups = [range(kg * TILE_K, kend, KEY_GROUPS * TILE_K)
                          for kg in range(KEY_GROUPS)]
                ms, ls = [], []
                for tiles in groups:  # pass A, each key group's tiles
                    m = torch.full((len(rows),), -math.inf)
                    l = torch.zeros(len(rows))
                    for j0 in tiles:
                        s, _ = logits(j0)
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        l = l * torch.exp(m - m_new) + torch.exp(
                            s - m_new[:, None]).sum(dim=1)
                        m = m_new
                    ms.append(m)
                    ls.append(l)
                m = functools.reduce(torch.maximum, ms)  # the groups merged
                l = sum(lg * torch.exp(mg - m) for mg, lg in zip(ms, ls))
                o = torch.zeros(len(rows), dh)
                for tiles in groups:  # pass B, the groups' contexts added
                    og = torch.zeros(len(rows), dh)
                    for j0 in tiles:
                        s, j1 = logits(j0)
                        w = torch.exp(s - m[:, None]) / l[:, None]
                        og += round_bf16(w) @ v[bi, j0:j1, cols]
                    o = o + og
                out[bi, rows[0]:rows[-1] + 1, cols] = o
                m_out[bi, h, rows[0]:rows[-1] + 1] = m
                l_out[bi, h, rows[0]:rows[-1] + 1] = l
    return out, m_out, l_out


def emulate_backward(heads, q, k, v, q_pad, k_pad, g):
    """K6 bf16's arithmetic from the emulated forward's max and sum and
    the f32 cotangent g: (dq, dk, dv) bf16."""
    q, k, v = q.float(), k.float(), v.float()
    b, lq, e = q.shape
    lk = k.shape[1]
    dh = e // heads
    scale = 1.0 / math.sqrt(dh)
    _, m_all, l_all = emulate_forward(heads, q, k, v, q_pad, k_pad)
    gr = round_bf16(g)
    dq, dk, dv = torch.zeros(b, lq, e), torch.zeros(b, lk, e), torch.zeros(
        b, lk, e)
    nqt = -(-lq // BWD_ROWS)
    for bi in range(b):
        fu = _first_unpadded(k_pad[bi], lk)
        full_tiles = {i // BWD_ROWS for i in range(lq)
                      if bool(q_pad[bi, i]) and fu >= visible(i, lq, lk)}
        for h in range(heads):
            cols = slice(h * dh, (h + 1) * dh)
            m, l = m_all[bi, h], l_all[bi, h]
            # D = rowsum(dw o w), tile by tile up to the causal horizon
            d_row = torch.zeros(lq)
            for i0 in range(0, lq, TILE_Q):
                rows = range(i0, min(i0 + TILE_Q, lq))
                sl = slice(rows[0], rows[-1] + 1)
                for j0 in range(0, visible(rows[-1], lq, lk), TILE_K):
                    j1 = min(j0 + TILE_K, lk)
                    s = _tile_logits(q[bi, sl, cols], k[bi, j0:j1, cols], j0,
                                     rows, lq, lk, q_pad[bi, sl],
                                     k_pad[bi, j0:j1], scale)
                    w = torch.exp(s - m[sl, None]) / l[sl, None]
                    dw = gr[bi, sl, cols] @ v[bi, j0:j1, cols].T
                    d_row[sl] += (w * dw).sum(dim=1)
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
                    qt, gt = q[bi, i0:i1, cols], gr[bi, i0:i1, cols]
                    masked = (j[:, None] * lq >= (i[None] + 1) * lk) | (
                        k_pad[bi, j0:j1][:, None] & q_pad[bi, i0:i1][None])
                    if vis:  # S^T and dW^T, once per (q tile, key block)
                        st, dwt = kt @ qt.T, vt @ gt.T
                    else:  # every pair masked: w alone, for dV
                        st = dwt = torch.zeros(j1 - j0, i1 - i0)
                    x = torch.where(masked, K5.NEG_INF, st * scale)
                    w = torch.exp(x - m[i0:i1][None]) / l[i0:i1][None]
                    ds = round_bf16(torch.where(
                        masked, 0.0, w * (dwt - d_row[i0:i1][None])))
                    dvt += round_bf16(w) @ gt
                    if vis:
                        dkt += ds @ qt
                        part[i0:i1] = ds.T @ kt
                dk[bi, j0:j1, cols] = dkt * scale
                dv[bi, j0:j1, cols] = dvt
                partials.append((r0, part))
            acc = torch.zeros(lq, dh)
            for r0, part in partials:  # key-block order
                acc[r0:] += part[r0:]
            dq[bi, :, cols] = acc * scale
    return dq.to(BF), dk.to(BF), dv.to(BF)


def flash_bf16(heads, q, k, v, q_pad, k_pad, g):
    """The control (tools/flash_bf16_probe.py): the f32 flash kernels'
    rounding on bf16 operands. The forward rounds the UNNORMALIZED weights
    exp(s - running max) per 64-key tile and divides by the row sum at
    the end; the backward takes D = rowsum(bf16(g) o context). Returns
    (context, dq, dk, dv)."""
    split = lambda x: K5._heads(heads, x)  # noqa: E731
    qh, kh, vh = split(q), split(k), split(v)
    w, mask = K5._weights(heads, q, k, q_pad, k_pad)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    b, h, lq, dh = qh.shape
    m = torch.full((b, h, lq, 1), -math.inf)
    l = torch.zeros(b, h, lq, 1)
    acc = torch.zeros(b, h, lq, dh)
    for j in range(0, kh.shape[2], TILE_K):
        s = qh @ kh[:, :, j:j + TILE_K].transpose(-1, -2) * scale
        s = s.masked_fill(mask[..., j:j + TILE_K], K5.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + round_bf16(p) @ vh[:, :, j:j + TILE_K]
        m = m_new
    ctx = acc / l
    gr = round_bf16(split(g))
    dw = gr @ vh.transpose(-1, -2)
    d = (gr * ctx).sum(-1, keepdim=True)
    ds = round_bf16((w * (dw - d)).masked_fill(mask, 0.0))
    grads = (ds @ kh * scale, ds.transpose(-1, -2) @ qh * scale,
             round_bf16(w).transpose(-1, -2) @ gr)
    return K5._merge(ctx), *[K5._merge(x).to(BF) for x in grads]


def _inputs(lq, lk, e, seed, full=()):
    """bf16 q, k, v, pads with ~10% padded rows and keys (with ``full``,
    those rows of batch 0 and every key they see padding, the rest of
    batch 0 unpadded), an f32 cotangent."""
    rng = np.random.default_rng(seed)
    q, k, v, g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, lq, e), (2, lk, e), (2, lk, e), (2, lq, e))]
    q_pad = torch.from_numpy(rng.random((2, lq)) < 0.1)
    k_pad = torch.from_numpy(rng.random((2, lk)) < 0.1)
    if full:
        q_pad[0] = False
        q_pad[0, list(full)] = True
        k_pad[0] = False
        k_pad[0, :visible(max(full), lq, lk)] = True
    return q.to(BF), k.to(BF), v.to(BF), q_pad, k_pad, g


def _jax(heads, q, k, v, q_pad, k_pad, g):
    """JAX's rect_attention on the bf16 operands: (context, dq, dk, dv)."""
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    out, vjp = jax.vjp(
        lambda a, b, c: jra.rect_attention(heads, a, b, c,
                                           jnp.asarray(q_pad.numpy()),
                                           jnp.asarray(k_pad.numpy())),
        jq, jk, jv)
    grads = vjp(jnp.asarray(g.numpy()))
    as_torch = lambda x: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(x).astype(jnp.float32)))
    return as_torch(out), *[as_torch(x) for x in grads]


def _plain(heads, q, k, v, q_pad, k_pad, g):
    """The plain bf16 version: (context, dq, dk, dv)."""
    with torch.no_grad():
        ctx = K5.rect_attention_bf16_reference(heads, q, k, v, q_pad, k_pad)
    return ctx, *K5.rect_attention_backward_reference(heads, q, k, v, q_pad,
                                                      k_pad, g)


def _distance(ctx, want, ctx32):
    """The context's mean error over the plain f32 version's mean distance
    from the reference (chip_smoke.py's distance test)."""
    return float((ctx - want).abs().mean() / (ctx32 - want).abs().mean())


def _within(got, want, ctx32, keep=None):
    """Context within BF16_ATTN_TOL and the distance test, gradients bf16
    within BF16_REL of their largest; ``keep`` (dq rows, dk batch rows)
    limits the gradients compared."""
    ctx, grads = got[0], got[1:]
    assert float((ctx - want[0]).abs().max()) <= BF16_ATTN_TOL
    assert _distance(ctx, want[0], ctx32) <= BF16_MODE_FRAC
    for i, (x, w) in enumerate(zip(grads, want[1:])):
        x, w = x.float(), w.float()
        if keep is not None:
            x, w = keep[i](x), keep[i](w)
        assert float((x - w).abs().max()) <= BF16_REL * float(
            w.abs().max()), "qkv"[i]


@pytest.mark.parametrize("lq,lk,e,heads,full", SCHEDULE_CASES)
def test_emulated_bf16_schedule_matches_plain_and_jax(lq, lk, e, heads,
                                                      full):
    q, k, v, q_pad, k_pad, g = _inputs(lq, lk, e, 5 * lq + lk + e, full)
    ctx, _, _ = emulate_forward(heads, q, k, v, q_pad, k_pad)
    got = (ctx, *emulate_backward(heads, q, k, v, q_pad, k_pad, g))
    assert [x.dtype for x in got[1:]] == [BF] * 3
    with torch.no_grad():
        ctx32 = K5.rect_attention_reference(heads, q.float(), k.float(),
                                            v.float(), q_pad, k_pad)
    _within(got, _plain(heads, q, k, v, q_pad, k_pad, g), ctx32)
    keep = None
    if full:
        # the JAX kernel averages a full row over Lk padded to 8 keys and
        # does not zero its dS where the mask is set, so it gives that row
        # a dq and adds to dk of its batch row (ROADMAP queue C): those
        # entries are held to the plain version only
        rows = np.ones(lq, bool)
        rows[list(full)] = False
        keep = (lambda x: x[:, rows], lambda x: x[1:], lambda x: x)
    _within(got, _jax(heads, q, k, v, q_pad, k_pad, g), ctx32, keep)


def test_emulated_residuals_are_the_row_max_and_sum():
    """Pass A's running max and sum end as the masked logits' row max and
    the sum of exp(logit - max) over every key (a fully masked row: -1e30
    and Lk)."""
    lq, lk, e, heads = 100, 200, 128, 2
    q, k, v, q_pad, k_pad, _ = _inputs(lq, lk, e, 3, (3, 9, 40))
    _, m, l = emulate_forward(heads, q, k, v, q_pad, k_pad)
    dh = e // heads
    qs = q.float().view(2, lq, heads, dh).transpose(1, 2)
    ks = k.float().view(2, lk, heads, dh).transpose(1, 2)
    logits = (qs @ ks.transpose(-1, -2)) / math.sqrt(dh)
    logits = logits.masked_fill(
        K5.rect_attention_mask(q_pad, k_pad)[:, None], K5.NEG_INF)
    want_m = logits.max(dim=-1).values
    want_l = torch.exp(logits - want_m[..., None]).sum(dim=-1)
    np.testing.assert_allclose(m.numpy(), want_m.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), want_l.numpy(), rtol=1e-5)
    assert float(l[0, 0, 3]) == lk


def test_flash_rounding_fails_the_distance_test():
    """The control: at B2 x 252 x 2016, E 256, 4 heads (the audio
    integrator's lengths and width), the flash rounding's context sits
    farther from the plain bf16 version than ``BF16_MODE_FRAC`` of the
    plain f32 version's distance, where the emulated schedule sits near
    it."""
    lq, lk, e, heads = 252, 2016, 256, 4
    q, k, v, q_pad, k_pad, g = _inputs(lq, lk, e, 29)
    with torch.no_grad():
        want = K5.rect_attention_bf16_reference(heads, q, k, v, q_pad, k_pad)
        ctx32 = K5.rect_attention_reference(heads, q.float(), k.float(),
                                            v.float(), q_pad, k_pad)
    flash = flash_bf16(heads, q.float(), k.float(), v.float(), q_pad, k_pad,
                       g)[0]
    ours = emulate_forward(heads, q, k, v, q_pad, k_pad)[0]
    assert _distance(ours, want, ctx32) <= BF16_MODE_FRAC
    assert _distance(flash, want, ctx32) > BF16_MODE_FRAC
