"""PyTorch port: K8's tensor-core arithmetic, emulated on CPU tensors.

The kernels of the LSTM recurrence over precomputed inputs
(``csrc/lstm_recurrence.cu``) compute each step's product in 3xTF32 on
the tensor cores and the weight gradient dW_hh in 3xTF32
(``csrc/tc_gemm.cuh reduce_rows_tn_tc``). The card tests hold the kernels
to the plain version; this file holds their ARITHMETIC to the plain
version and to the JAX kernel where no card is needed:

  * ``emulate_forward`` repeats the forward kernel's algorithm in torch
    f32: per step, the gate pre-activations h_{t-1} @ w_hh_t with the
    product's K range split over the KS warps of a unit group (KS = 64 C
    / H for a cluster of C CTAs, at every size the kernels take,
    ``ops/lstm_recurrence.py CLUSTER_CTAS``), each warp's sum kept as two
    accumulators, the even k-steps (k % 4 in {0, 1} within its range, the
    kernel's permuted fragment order) and the odd ones, added, then the
    warps' partials added in warp order and xw last; every product from
    TF32 hi and lo parts with FP32 sums, lo*hi + hi*lo + hi*hi; the cell
    in f32 as the kernel's, saving the activations and cell states;
  * ``emulate_backward`` repeats the backward kernel's: per reverse step
    dh = dy + dh_n at the last step, else dy + the partial carries of
    CTAs 0..C-1 in that order, the cell's backward from the activations
    and cell states (dc carried), then each CTA's partial carry
    dgates[:, its 4U columns] @ W_slice^T in 3xTF32 (even and odd k-steps
    apart); dW_hh = h_shift^T dgates over all B*T rows in 3xTF32 split-K,
    the partials summed in split order;
  * both match ``lstm_recurrence_reference`` and the JAX ``ops/
    pallas_lstm.py lstm_recurrence`` and its VJP (Pallas in interpret
    mode, as tests/test_torch_port_lstm_recurrence.py runs it) at H 64,
    128, 192 and 256 (every cluster size of each), B 1, 17 and 33 (a ragged second cluster), T 1, 7 and 37: ys,
    h_n and c_n within ``FWD_ATOL`` = 1e-5 abs (three TF32 passes keep
    FP32's order of error; what is left is summation order through the
    recurrence), and dxw, dw_hh_t, dh0 and dc0 within ``GRAD_REL`` = 1e-4
    of the largest entry of each (dW_hh sums B*T products of both signs);
  * one TF32 pass instead of three drifts by more than 3xTF32 does;
  * ``cluster_size.cluster_ctas`` over ``CLUSTER_CTAS``, the wrapper's
    choice of cluster size: the faster size while the card holds every
    cluster of the batch at once; ``cluster_size.launch_ctas`` asks the
    card once per kernel, device and size.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_lstm
from multimodalreactiongeneration_tpu_torch.ops import cluster_size
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from tests.tf32_emulation import chain_product, reduce_rows

torch.set_num_threads(1)
FWD_ATOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def emulate_forward(xw, w_hh_t, h0, c0, ctas, passes=3):
    """K8's forward arithmetic over clusters of ``ctas`` CTAs: (ys (B, T,
    H), hn, cn (B, H), acts (B, T, 4H), cs (B, T, H))."""
    h = h0.shape[1]
    splits = 64 * ctas // h  # KS: warps splitting K
    hcur, c, ys, acts, cs = h0, c0, [], [], []
    for t in range(xw.shape[1]):
        pre = chain_product(hcur, w_hh_t, passes, splits) + xw[:, t]
        i, f, g, o = pre.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        hcur = o * torch.tanh(c)
        ys.append(hcur)
        acts.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
    stack = functools.partial(torch.stack, dim=1)
    return stack(ys), hcur, c, stack(acts), stack(cs)


def emulate_backward(w_hh_t, h0, c0, ys, acts, cs, dys, dhn, dcn, ctas,
                     passes=3):
    """K8's backward arithmetic over clusters of ``ctas`` CTAs, from the
    forward's ys, acts and cs: (dxw, dw_hh_t, dh0, dc0)."""
    b, t, h = ys.shape
    u = h // ctas
    # CTA r's local gate columns, gate-major: w_hh_t's columns g H + r U + i
    cols = [torch.cat([torch.arange(g * h + r * u, g * h + (r + 1) * u)
                       for g in range(4)]) for r in range(ctas)]
    h_shift = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
    c_shift = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    dc, slots = dcn, [dhn]
    dxw = torch.zeros(b, t, 4 * h)
    for s in reversed(range(t)):
        dh = dys[:, s]
        for slot in slots:
            dh = dh + slot
        ai, af, ag, ao = acts[:, s].chunk(4, dim=-1)
        tc = torch.tanh(cs[:, s])
        dcc = dh * ao * (1.0 - tc * tc) + dc
        dxw[:, s] = torch.cat([dcc * ag * ai * (1.0 - ai),
                               dcc * c_shift[:, s] * af * (1.0 - af),
                               dcc * ai * (1.0 - ag * ag),
                               dh * tc * ao * (1.0 - ao)], dim=-1)
        dc = dcc * af
        slots = [chain_product(dxw[:, s][:, c], w_hh_t[:, c].T, passes)
                 for c in cols]
    dh0 = torch.zeros(b, h)
    for slot in slots:
        dh0 = dh0 + slot
    dw = reduce_rows(h_shift.reshape(-1, h), dxw.reshape(-1, 4 * h), passes)
    return dxw, dw, dh0, dc


def _inputs(seed, b, t, h):
    """chip_smoke.py phase 18's scales."""
    rng = np.random.default_rng(seed)
    args = [(s * rng.standard_normal(x)).astype(np.float32) for x, s in (
        ((b, t, 4 * h), 0.5), ((h, 4 * h), 0.06), ((b, h), 0.3),
        ((b, h), 0.3))]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h), (b, h))]
    return args, cots


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _emulate(args, cots, ctas, passes=3):
    xw, w, h0, c0 = args
    ys, hn, cn, acts, cs = emulate_forward(xw, w, h0, c0, ctas, passes)
    grads = emulate_backward(w, h0, c0, ys, acts, cs, *cots, ctas, passes)
    return (ys, hn, cn), grads


@pytest.mark.parametrize("t", [1, 7, 37])
@pytest.mark.parametrize("b", [1, 17, 33])
@pytest.mark.parametrize("h", [64, 128, 192, 256])
def test_emulated_tensor_core_lstm_recurrence_matches_plain_and_jax(h, b, t):
    """Every cluster size the kernels take at this H."""
    args, cots = _inputs(1000 * b + 10 * t + h, b, t, h)
    targs = [torch.from_numpy(a) for a in args]
    tcots = [torch.from_numpy(c) for c in cots]
    ysr, (hnr, cnr) = K8.lstm_recurrence_reference(*targs)
    want = K8.lstm_recurrence_backward_reference(targs, *tcots)
    jargs = [jnp.asarray(a) for a in args]
    (jys, (jhn, jcn)), vjp = jax.vjp(pallas_lstm.lstm_recurrence, *jargs)
    jgrads = [torch.from_numpy(np.array(g)) for g in vjp(
        (jnp.asarray(cots[0]), (jnp.asarray(cots[1]),
                                jnp.asarray(cots[2]))))]
    for ctas in K8.CLUSTER_CTAS[h]:
        outs, grads = _emulate(targs, tcots, ctas)
        for got, plain, jx, name in zip(outs, (ysr, hnr, cnr),
                                        (jys, jhn, jcn), ("ys", "hn", "cn")):
            np.testing.assert_allclose(
                got.numpy(), plain.numpy(), atol=FWD_ATOL,
                err_msg=f"{name} vs plain, {ctas} CTAs")
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jx), atol=FWD_ATOL,
                err_msg=f"{name} vs JAX, {ctas} CTAs")
        for got, plain, jg, name in zip(grads, want, jgrads,
                                        ("dxw", "dw_hh_t", "dh0", "dc0")):
            assert _rel(got, plain) <= GRAD_REL, f"{name} vs plain, {ctas}"
            assert _rel(got, jg) <= GRAD_REL, f"{name} vs JAX, {ctas}"


def test_three_tf32_passes_hold_where_one_drifts():
    args, cots = _inputs(5, 17, 37, 256)
    targs = [torch.from_numpy(a) for a in args]
    tcots = [torch.from_numpy(c) for c in cots]
    ysr, _ = K8.lstm_recurrence_reference(*targs)
    want = K8.lstm_recurrence_backward_reference(targs, *tcots)
    fwd_err, grad_err = [], []
    for passes in (3, 1):
        (ys, _, _), grads = _emulate(targs, tcots, 16, passes)
        fwd_err.append(float((ys - ysr).abs().max()))
        grad_err.append(max(_rel(g, p) for g, p in zip(grads, want)))
    assert fwd_err[0] <= FWD_ATOL < fwd_err[1]
    assert grad_err[0] <= GRAD_REL < grad_err[1]


def test_cluster_ctas_takes_the_faster_size_while_every_cluster_fits():
    """The larger cluster while ceil(B / 16) clusters of it fit on the
    card at once, else the smaller: at H 256 16 CTAs (an H100 holds 7 such
    clusters: up to B112), else 8; at H 128 8 CTAs (15: up to B240), else
    4; the smaller where the occupancy query failed."""
    def resident(ctas):
        return {16: 7, 8: 15, 4: 30}[ctas]

    sizes = K8.CLUSTER_CTAS
    assert [cluster_size.cluster_ctas(b, sizes[256], resident)
            for b in (1, 16, 17, 112, 113, 128, 300)] == [16] * 4 + [8] * 3
    assert [cluster_size.cluster_ctas(b, sizes[128], resident)
            for b in (1, 20, 240, 241, 256, 600)] == [8] * 3 + [4] * 3
    assert cluster_size.cluster_ctas(32, sizes[256], lambda ctas: -1) == 8
    assert cluster_size.cluster_ctas(32, sizes[128], lambda ctas: -1) == 4


def test_launch_ctas_asks_the_card_once_per_kernel_device_and_size(
        monkeypatch):
    """The occupancy query of each (kernel, device, cluster size) runs
    once, on that device; later launches read the answer kept: K8 at H 128
    holds 15 clusters of 8 CTAs, so B240 runs over 8 and B241 over 4."""
    asked, entered = [], []
    monkeypatch.setattr(cluster_size, "_RESIDENT", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: entered.append(d) or contextlib.nullcontext())

    def query(ctas):
        asked.append(ctas)
        return {8: 15, 4: 30}[ctas]

    dev = [torch.device("cuda", i) for i in (0, 1)]
    sizes = K8.CLUSTER_CTAS[128]
    got = [cluster_size.launch_ctas("K8 H128", dev[0], b, sizes, query)
           for b in (1, 240, 241, 256, 1)]
    assert got == [8, 8, 4, 4, 8] and asked == [8]
    assert cluster_size.launch_ctas("K8 H128", dev[1], 241, sizes,
                                    query) == 4
    assert cluster_size.launch_ctas("K10 H128", dev[0], 1, sizes, query) == 8
    assert asked == [8, 8, 8] and entered == [dev[0], dev[1], dev[0]]
