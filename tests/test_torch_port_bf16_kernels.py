"""PyTorch port: the bf16 operand modes of K7 and K9, their routes in
``TorchLSTM`` and the bf16 dense layers, vs the JAX package on the CPU.

The JAX side runs as its own tests run it: the Pallas calls in interpret
mode, ``TorchLSTM`` with ``impl="pallas"`` (the kernels' routes), bf16
parameters cast as its harness's ``_cast_tree`` casts them. The same
numpy inputs go through both.

  * K7 (``ops/lstm_layer.py``) and K9 (``ops/lstm_stacked.py``): the
    plain bf16 versions vs JAX ``lstm_layer`` / ``lstm_stacked_recurrence``
    with bf16 weights, at T 16 and 61: outputs, states and every
    gradient, gradient dtypes included. Both round the same operands to
    bf16 and sum in f32, so at T 16 they agree to f32 rounding: outputs
    and the f32 gradients atol 2e-5 (the sums run in another order), the
    bf16 gradients within 1e-2 of their largest magnitude (a sum that
    lands on a bf16 rounding boundary may round to the neighbour, one
    bf16 ulp, 2^-8 to 2^-7 of the value). Over longer sequences an h on a
    rounding boundary may round the other way in one of them and the
    flip compounds (4.7e-4 on K9's ys at T 61): there the JAX bf16
    bounds hold (tests/test_pallas_lstm.py:130: 5e-2 abs on outputs,
    states and f32 gradients, 0.3 on the bf16 dW).
  * ``TorchLSTM`` with bf16 parameters on the stacked route (K9), the
    single-layer route (K7) and the under-16-step scan route (JAX's
    ``_lstm_scan`` in bf16, bf16 carries): outputs and states in bf16,
    within 2 bf16 ulps of JAX's (2^-7 of the largest magnitude, plus
    1e-6); the kernel routes' parameter gradients (bf16) likewise
    within 2e-2 of their largest magnitude. XLA on the CPU keeps f32
    through fused elementwise chains where the program says bf16, eager
    PyTorch rounds every operation, so the two may differ by an ulp.
  * flax's ``Dense`` and ``LayerNorm`` on bf16 (the port's ``Dense``
    rounds the product, then the bias add; ``LayerNorm`` computes in f32
    and rounds once): bit for bit.
  * Refusals: mixes of dtypes that are no mode of K7 or K9 raise, naming
    the kernel. (K8's bf16 route is held in
    tests/test_torch_port_bf16_recurrence.py.)
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchLSTM as JaxTorchLSTM,
)
from multimodalreactiongeneration_tpu.ops import pallas_lstm, pallas_lstm_stacked
from multimodalreactiongeneration_tpu.train.harness import _cast_tree
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import basic, recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
BF = torch.bfloat16
ATOL = 2e-5          # f32 values: the same products, sums in another order
BF16_REL = 1e-2      # a bf16 gradient: one ulp of its largest magnitude
ROUTE_REL = 2 ** -7  # the routes in bf16: two ulps


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch_like(jargs):
    """The JAX arrays as torch tensors of the same dtypes."""
    return [torch.from_numpy(np.array(_np(a))).to(BF if a.dtype == jnp.bfloat16
                                        else torch.float32) for a in jargs]


def _grads_match(got, want, short):
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        lowp = g.dtype == BF
        g, w = g.float().numpy(), _np(w)
        if not short:
            assert np.abs(g - w).max() <= (0.3 if lowp else 5e-2), i
        elif lowp:
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max(), i
        else:
            np.testing.assert_allclose(g, w, atol=ATOL * max(
                1.0, np.abs(w).max()), err_msg=str(i))


def _run_both(jfn, pfn, jargs, cots):
    """Outputs and all input gradients of the JAX and the port function
    under one random cotangent; tight up to T 16 (the docstring)."""
    short = cots[0].shape[1] <= 16
    def loss(*a):
        ys, (hn, cn) = jfn(*a)
        return sum(jnp.sum(o * c) for o, c in zip((ys, hn, cn), cots))

    want = jfn(*jargs)
    want_grads = jax.grad(loss, argnums=tuple(range(6)))(*jargs)
    leaves = [a.requires_grad_() for a in _torch_like(jargs)]
    ys, (hn, cn) = pfn(*leaves)
    grads = torch.autograd.grad(
        (ys, hn, cn), leaves, [torch.from_numpy(c) for c in cots])
    for g, w in zip((ys, hn, cn), (want[0], *want[1])):
        assert g.dtype == torch.float32  # the state stays f32
        np.testing.assert_allclose(g.detach().numpy(), _np(w),
                                   atol=ATOL if short else 5e-2)
    _grads_match(grads, want_grads, short)
    return grads


@pytest.mark.parametrize("t", [16, 61])
def test_plain_lstm_layer_bf16_matches_jax(t):
    rng = np.random.default_rng(t)
    b, din, h = 3, 24, 16
    shapes = [(b, t, din), (din, 4 * h), (4 * h,), (h, 4 * h), (b, h), (b, h)]
    dts = [jnp.bfloat16, jnp.bfloat16, jnp.float32, jnp.bfloat16,
           jnp.float32, jnp.float32]
    jargs = [jnp.asarray((0.3 * rng.standard_normal(s)).astype(np.float32))
             .astype(d) for s, d in zip(shapes, dts)]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h), (b, h))]
    before = K7.bf16_fwd_launches, K7.fwd_launches
    grads = _run_both(pallas_lstm.lstm_layer, K7.lstm_layer, jargs, cots)
    assert (K7.bf16_fwd_launches, K7.fwd_launches) == before  # CPU: plain
    assert [g.dtype for g in grads] == [BF, BF, torch.float32, BF,
                                        torch.float32, torch.float32]
    # the plain backward alone gives the same gradients
    args = [a.detach() for a in _torch_like(jargs)]
    again = K7.lstm_layer_backward_reference(
        args, *[torch.from_numpy(c) for c in cots])
    for g, a in zip(grads, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("t,layers", [(16, 3), (61, 2)])
def test_plain_lstm_stacked_bf16_matches_jax(t, layers):
    rng = np.random.default_rng(t + layers)
    b, h = 3, 16
    shapes = [(b, t, 4 * h), (layers - 1, h, 4 * h), (layers - 1, 4 * h),
              (layers, h, 4 * h), (layers, b, h), (layers, b, h)]
    dts = [jnp.float32, jnp.bfloat16, jnp.float32, jnp.bfloat16,
           jnp.float32, jnp.float32]
    jargs = [jnp.asarray((0.3 * rng.standard_normal(s)).astype(np.float32))
             .astype(d) for s, d in zip(shapes, dts)]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (layers, b, h), (layers, b, h))]
    grads = _run_both(pallas_lstm_stacked.lstm_stacked_recurrence,
                      K9.lstm_stacked_recurrence, jargs, cots)
    assert [g.dtype for g in grads] == [torch.float32, BF, torch.float32, BF,
                                        torch.float32, torch.float32]


@pytest.mark.parametrize("mod,args,match", [
    (K7, "x f32", "K7"), (K7, "b_sum bf16", "K7"), (K9, "xw0 bf16", "K9"),
    (K9, "w_ih_t f32", "K9"),
])
def test_bf16_modes_refuse_other_mixes(mod, args, match):
    name, dtype = args.split()
    dtype = BF if dtype == "bf16" else torch.float32
    if mod is K7:
        t = dict(x=torch.zeros(2, 3, 8, dtype=BF), w_ih_t=torch.zeros(
            8, 16, dtype=BF), b_sum=torch.zeros(16), w_hh_t=torch.zeros(
            4, 16, dtype=BF), h0=torch.zeros(2, 4), c0=torch.zeros(2, 4))
        fn = mod.lstm_layer
    else:
        t = dict(xw0=torch.zeros(2, 3, 16), w_ih_t=torch.zeros(
            1, 4, 16, dtype=BF), b_rest=torch.zeros(1, 16), w_hh_t=torch.zeros(
            2, 4, 16, dtype=BF), h0=torch.zeros(2, 2, 4), c0=torch.zeros(
            2, 2, 4))
        fn = mod.lstm_stacked_recurrence
    t[name] = t[name].to(dtype)
    with pytest.raises(ValueError, match=match):
        fn(*t.values())


# ---- TorchLSTM with bf16 parameters --------------------------------------

def _route_pair(monkeypatch, din, hidden, layers, t, seed):
    """(JAX outputs, parameter gradients; port outputs, gradients) of a
    bf16 TorchLSTM on the same bf16 input and parameters."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, din)).astype(np.float32)
    jm = JaxTorchLSTM(input_size=din, hidden_size=hidden, num_layers=layers,
                      impl="pallas")
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pb = _cast_tree(params, jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def loss(p):
        ys, (hn, cn) = jm.apply(p, xb)
        return (jnp.sum(ys.astype(jnp.float32) * 0.5)
                + jnp.sum(hn.astype(jnp.float32) * cn.astype(jnp.float32)))

    ys, (hn, cn) = jm.apply(pb, xb)
    jgrads = flat_params(jax.grad(loss)(pb))

    pm = recurrent.TorchLSTM(din, hidden, torch.Generator().manual_seed(0),
                             num_layers=layers)
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    pm.to(BF)
    pys, (phn, pcn) = pm(torch.from_numpy(_np(xb)).to(BF))
    ploss = (pys.float() * 0.5).sum() + (phn.float() * pcn.float()).sum()
    ploss.backward()
    pgrads = {k: p.grad for k, p in pm.named_parameters()}
    return (ys, hn, cn), jgrads, (pys, phn, pcn), pgrads


def _close_bf16(got, want, rel):
    g, w = got.detach().float().numpy(), _np(want)
    assert np.abs(g - w).max() <= rel * np.abs(w).max() + 1e-6


@pytest.mark.parametrize("route,din,hidden,layers,t", [
    ("lstm_stacked", 16, 32, 2, 24),   # K9
    ("lstm_layer", 128, 128, 1, 17),   # K7
    ("plain", 24, 16, 2, 7),           # JAX's bf16 _lstm_scan
])
def test_torch_lstm_bf16_routes_match_jax(monkeypatch, route, din, hidden,
                                          layers, t):
    if route == "lstm_layer":
        assert recurrent.single_layer_route("cpu", t, din, hidden) == route
    want, jgrads, got, pgrads = _route_pair(monkeypatch, din, hidden, layers,
                                            t, seed=din + t)
    for g, w in zip(got, want):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        _close_bf16(g, w, ROUTE_REL)
    sd = state_dict_from_jax(jgrads)
    assert set(sd) == set(pgrads)
    for name, g in pgrads.items():
        assert g.dtype == BF, name
        _close_bf16(g, sd[name], 2e-2)


# ---- the dense layers in bf16 -----------------------------------------------

def test_dense_and_layer_norm_round_as_flax():
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((5, 7, 64)).astype(np.float32))
    xb = x.astype(jnp.bfloat16)
    xt = torch.from_numpy(_np(xb)).to(BF)
    dense = fnn.Dense(48)
    p = dense.init(jax.random.PRNGKey(0), x)
    p = jax.tree_util.tree_map(lambda a: a + 0.1, p)  # a bias that counts
    pb = _cast_tree(p, jnp.bfloat16)
    pd = basic.dense(64, 48, torch.Generator().manual_seed(0))
    pd.load_state_dict(state_dict_from_jax(flat_params(p)), strict=True)
    pd.to(BF)
    assert torch.equal(pd(xt).float(),
                       torch.from_numpy(_np(dense.apply(pb, xb))))
    ln = fnn.LayerNorm(epsilon=basic.LN_EPS)
    lp = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                  jnp.float32), ln.init(jax.random.PRNGKey(1),
                                                        x))
    want = ln.apply(_cast_tree(lp, jnp.bfloat16), xb)
    assert want.dtype == jnp.bfloat16
    pl_ = basic.LayerNorm(64)
    pl_.load_state_dict(state_dict_from_jax(flat_params(lp)), strict=True)
    pl_.to(BF)
    got = pl_(xt)
    assert got.dtype == BF
    # one rounding of an f32 value computed in another order
    _close_bf16(got, want, 2 ** -8)
