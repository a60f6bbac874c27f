"""PyTorch port: K10's tensor-core arithmetic, emulated on CPU tensors.

The GRU recurrence kernels (``csrc/gru.cu``) compute each step's products
in 3xTF32 on the tensor cores and the weight gradient dW_hh in 3xTF32
(``csrc/tc_gemm.cuh reduce_rows_tn_tc``). The card tests hold the kernels
to the plain version; this file holds their ARITHMETIC to the plain
version and to the JAX kernel where no card is needed:

  * ``emulate_forward`` repeats the forward kernel's algorithm in torch
    f32: per step, hh = h_{t-1} @ w_hh_t + b_hh with the product's K range
    split over the KS warps of a unit group (KS = 64 C / H for a cluster
    of C CTAs: at H 256 both sizes the kernels take, 16 and 8,
    ``ops/gru.py CLUSTER_CTAS``), each warp's sum kept as two
    accumulators, the even k-steps (k % 4 in {0, 1} within its range, the
    kernel's permuted fragment order) and the odd ones, added, then the
    warps' partials added in warp order and the bias last; every product
    from TF32 hi and lo parts with FP32 sums, lo*hi + hi*lo + hi*hi; the
    cell in f32 as the kernel's;
  * ``emulate_backward`` repeats the backward kernel's: per reverse step
    dh = dy + the local carry + the partial carries of CTAs 0..C-1 in
    that order, the cell, then each CTA's partial carry dhh[:, its 3U
    columns] @ W_slice^T in 3xTF32 (even and odd k-steps apart); dW_hh =
    h_shift^T dhh over all B*T rows in 3xTF32, db_hh the column sum;
  * both match ``gru_recurrence_reference`` and the JAX ``ops/pallas_gru.py
    gru_recurrence`` and its VJP (Pallas in interpret mode, as
    tests/test_torch_port_gru.py runs it) at H 128 and 256, B 1, 17 and
    33 (a ragged second cluster), T 1, 7 and 37: ys and hn within
    ``FWD_ATOL`` = 1e-5 abs (three TF32 passes keep FP32's order of
    error; what is left is summation order through the recurrence), and
    dxw, dw_hh_t, db_hh and dh0 within ``GRAD_REL`` = 1e-4 of the largest
    entry of each (dW_hh sums B*T products of both signs);
  * one TF32 pass instead of three drifts by more than 3xTF32 does;
  * ``cluster_size.cluster_ctas`` over ``CLUSTER_CTAS``, the wrapper's
    choice of cluster size: the faster size while the card holds every
    cluster of the batch at once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_gru
from multimodalreactiongeneration_tpu_torch.ops import gru as K10
from multimodalreactiongeneration_tpu_torch.ops.cluster_size import cluster_ctas
from tests.tf32_emulation import chain_product, product

torch.set_num_threads(1)
FWD_ATOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def emulate_forward(xw, w_hh_t, b_hh, h0, ctas, passes=3):
    """K10's forward arithmetic over clusters of ``ctas`` CTAs: (ys (B, T,
    H), hn (B, H), hh (B, T, 3H))."""
    h = h0.shape[1]
    splits = 64 * ctas // h  # KS: warps splitting K
    hcur, ys, hhs = h0, [], []
    for t in range(xw.shape[1]):
        hh = chain_product(hcur, w_hh_t, passes, splits) + b_hh
        hr, hz, hn = hh.chunk(3, dim=-1)
        xr, xz, xn = xw[:, t].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        hcur = (1.0 - z) * n + z * hcur
        ys.append(hcur)
        hhs.append(hh)
    return torch.stack(ys, dim=1), hcur, torch.stack(hhs, dim=1)


def emulate_backward(xw, w_hh_t, h0, ys, hh, dys, dhn, ctas, passes=3):
    """K10's backward arithmetic over clusters of ``ctas`` CTAs, from the
    forward's ys and hh: (dxw, dw_hh_t, db_hh, dh0)."""
    b, t, g3 = xw.shape
    h = g3 // 3
    cl = ctas
    u = h // cl
    # CTA r's local gate columns, gate-major: w_hh_t's columns g H + r U + i
    cols = [torch.cat([torch.arange(g * h + r * u, g * h + (r + 1) * u)
                       for g in range(3)]) for r in range(cl)]
    h_shift = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
    carry, slots = dhn, []
    dxw, dhh = torch.zeros_like(xw), torch.zeros_like(xw)
    for s in reversed(range(t)):
        dh = dys[:, s] + carry
        for slot in slots:
            dh = dh + slot
        hr, hz, hn = hh[:, s].chunk(3, dim=-1)
        xr, xz, xn = xw[:, s].chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dz = dh * (h_shift[:, s] - n)
        dgn = dh * (1.0 - z) * (1.0 - n * n)
        dgr = dgn * hn * r * (1.0 - r)
        dgz = dz * z * (1.0 - z)
        carry = dh * z
        dxw[:, s] = torch.cat([dgr, dgz, dgn], dim=-1)
        dhh[:, s] = torch.cat([dgr, dgz, dgn * r], dim=-1)
        slots = [chain_product(dhh[:, s][:, c], w_hh_t[:, c].T, passes)
                 for c in cols]
    dh0 = carry
    for slot in slots:
        dh0 = dh0 + slot
    dw = product(h_shift.reshape(-1, h).T, dhh.reshape(-1, g3), passes)
    return dxw, dw, dhh.sum(dim=(0, 1)), dh0


def _inputs(seed, b, t, h):
    """chip_smoke.py phase 14's scales."""
    rng = np.random.default_rng(seed)
    args = [(s * rng.standard_normal(x)).astype(np.float32) for x, s in (
        ((b, t, 3 * h), 0.5), ((h, 3 * h), 0.06), ((3 * h,), 0.1),
        ((b, h), 0.3))]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h))]
    return args, cots


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("t", [1, 7, 37])
@pytest.mark.parametrize("b", [1, 17, 33])
@pytest.mark.parametrize("h", [128, 256])
def test_emulated_tensor_core_gru_matches_plain_and_jax(h, b, t):
    """Every cluster size the kernels take at this H."""
    args, cots = _inputs(1000 * b + 10 * t + h, b, t, h)
    xw, w, bias, h0 = [torch.from_numpy(a) for a in args]
    dys, dhn = [torch.from_numpy(c) for c in cots]
    ysr, hnr = K10.gru_recurrence_reference(xw, w, bias, h0)
    want = K10.gru_backward_reference([xw, w, bias, h0], dys, dhn)
    jargs = [jnp.asarray(a) for a in args]
    (jys, jhn), vjp = jax.vjp(pallas_gru.gru_recurrence, *jargs)
    jgrads = [torch.from_numpy(np.array(g)) for g in vjp(
        (jnp.asarray(cots[0]), jnp.asarray(cots[1])))]
    for ctas in K10.CLUSTER_CTAS[h]:
        ys, hn, hh = emulate_forward(xw, w, bias, h0, ctas)
        grads = emulate_backward(xw, w, h0, ys, hh, dys, dhn, ctas)
        for got, plain, jx, name in ((ys, ysr, jys, "ys"),
                                     (hn, hnr, jhn, "hn")):
            np.testing.assert_allclose(
                got.numpy(), plain.numpy(), atol=FWD_ATOL,
                err_msg=f"{name} vs plain, {ctas} CTAs")
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jx), atol=FWD_ATOL,
                err_msg=f"{name} vs JAX, {ctas} CTAs")
        for got, plain, jg, name in zip(grads, want, jgrads,
                                        ("dxw", "dw_hh_t", "db_hh", "dh0")):
            assert _rel(got, plain) <= GRAD_REL, f"{name} vs plain, {ctas}"
            assert _rel(got, jg) <= GRAD_REL, f"{name} vs JAX, {ctas}"


def test_three_tf32_passes_hold_where_one_drifts():
    args, cots = _inputs(5, 17, 37, 256)
    xw, w, bias, h0 = [torch.from_numpy(a) for a in args]
    dys, dhn = [torch.from_numpy(c) for c in cots]
    ysr, _ = K10.gru_recurrence_reference(xw, w, bias, h0)
    want = K10.gru_backward_reference([xw, w, bias, h0], dys, dhn)
    fwd_err, grad_err = [], []
    for passes in (3, 1):
        ys, _, hh = emulate_forward(xw, w, bias, h0, 16, passes)
        fwd_err.append(float((ys - ysr).abs().max()))
        grads = emulate_backward(xw, w, h0, ys, hh, dys, dhn, 16, passes)
        grad_err.append(max(_rel(g, p) for g, p in zip(grads, want)))
    assert fwd_err[0] <= FWD_ATOL < fwd_err[1]
    assert grad_err[0] <= GRAD_REL < grad_err[1]


def test_cluster_ctas_takes_the_faster_size_while_every_cluster_fits():
    """16 CTAs at H 256 while ceil(B / 16) clusters of them fit on the
    card at once (an H100 holds 7), else 8; always 8 at H 128."""
    def resident(ctas):
        return {16: 7, 8: 15}[ctas]

    sizes = K10.CLUSTER_CTAS
    assert [cluster_ctas(b, sizes[256], resident)
            for b in (1, 16, 17, 112, 113, 128, 300)] == [16] * 4 + [8] * 3
    assert {cluster_ctas(b, sizes[128], resident) for b in (1, 300)} == {8}
    assert cluster_ctas(32, sizes[256], lambda ctas: -1) == 8  # query failed
