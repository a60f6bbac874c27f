"""PyTorch port: the bf16 operand modes of the GRU recurrence (K10) and
the LSTM recurrence over precomputed inputs (K8), and the bf16 routes of
``TorchGRU`` and of ``TorchLSTM`` through K8, vs the JAX package on the
CPU.

The JAX side runs as its own tests run it: the Pallas calls in interpret
mode, the modules with ``impl="pallas"`` (the kernels' routes), bf16
parameters cast as its harness's ``_cast_tree`` casts them. The same
numpy inputs go through both.

  * The plain bf16 K10 (``ops/gru.py``) vs JAX ``gru_recurrence`` with
    bf16 ``w_hh_t``, and the plain bf16 K8 (``ops/lstm_recurrence.py``) vs
    JAX ``lstm_recurrence`` with bf16 ``w_hh_t``, at T 16 and 37 (the
    shapes of tests/test_pallas_lstm.py:130, :165): outputs, states and
    every gradient, each in JAX's dtype, at the bounds of
    tests/test_torch_port_bf16_kernels.py. Both round the same operands to
    bf16 and sum in f32, so at T 16 they agree to f32 rounding: outputs
    and the f32 gradients atol 2e-5 (sums in another order; observed
    1e-6), the bf16 dW_hh within 1e-2 of its largest magnitude (one bf16
    ulp; a sum on a rounding boundary may round to the neighbour;
    observed equal). Over longer sequences an h or a dgate on a rounding
    boundary may round the other way in one of them and the flip
    compounds (K8's dxw 3.6e-4 at T 37): there the JAX bf16 bounds hold
    (tests/test_pallas_lstm.py:130: 5e-2 abs on outputs, states and f32
    gradients, 0.3 on the bf16 dW). The plain backward alone gives the
    autograd gradients bit for bit.
  * ``TorchGRU`` with bf16 parameters on the kernel route (from 16 steps,
    on bf16 input and on f32 input, as the later Metaformer blocks feed
    it) and below ``MIN_KERNEL_STEPS`` (JAX's ``_gru_scan`` in x's dtype),
    and ``TorchLSTM`` with bf16 parameters on K8's route (under
    ``MRGEN_FUSED_DW=0`` at 128 -> 128, and at the unaligned 24 -> 128
    with the default): on the kernel routes outputs and states in x's
    dtype within 2 bf16 ulps of JAX's (2^-7 of the largest magnitude, plus
    1e-6; observed equal, or within 1e-7 on f32 input), the parameter
    gradients (bf16) within 2e-2 of their largest magnitude (observed
    6.4e-5). Below 16 steps both sides round every gate op to bf16, but
    XLA computes its bf16 sigmoid and tanh in its own f32 expansions and
    PyTorch in its own, so a value on a rounding boundary rounds the
    other way now and then and the flips compound along the chain: there
    the outputs hold to 4 ulps (2^-6; over 6 seeds the GRU read 6.0e-3 to
    1.17e-2, and the LSTM's scan route, held in
    tests/test_torch_port_bf16_kernels.py, 8.3e-3 to 1.63e-2:
    tests/bf16_step_survey.py ``--model scan_routes``), the gradients to
    2e-2 (the GRU 9.2e-3 to 1.45e-2).
  * Mixes of dtypes that are no mode of K8 or K10 raise, naming the
    kernel.
  * Over a long chain a bf16 rounding flip compounds: the card's distance
    test of the bf16 modes (chip_smoke.py ``bf16_check``: the kernel's ys
    within ``BF16_MODE_FRAC`` of the plain f32 version's distance from the
    plain bf16 ys) reads the first ``MODE_STEPS`` steps of a long
    sequence. There the plain bf16 version on inputs moved by one f32 ulp
    stays within 0.1 of that bound (observed 0.004 to 0.016 at B32 x T252
    x H256), where over all 252 steps it reads 0.28 to 0.34
    (tools/bf16_chaos_probe.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchGRU as JaxTorchGRU,
)
from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchLSTM as JaxTorchLSTM,
)
from multimodalreactiongeneration_tpu.ops import pallas_gru, pallas_lstm
from multimodalreactiongeneration_tpu.train.harness import _cast_tree
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import recurrent
from multimodalreactiongeneration_tpu_torch.ops import gru as K10
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
BF = torch.bfloat16
ATOL = 2e-5          # f32 values: the same products, sums in another order
BF16_REL = 1e-2      # a bf16 gradient: one ulp of its largest magnitude
ROUTE_REL = 2 ** -7  # the kernel routes in bf16: two ulps
SCAN_REL = 2 ** -6   # the routes under 16 steps: four ulps


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    """A JAX array as a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(BF) if x.dtype == jnp.bfloat16 else t


def _flatten(out):
    """(ys, hn) or (ys, (hn, cn)) as a flat tuple."""
    ys, state = out
    return (ys, *state) if isinstance(state, tuple) else (ys, state)


def _jargs(rng, shapes):
    """JAX arguments from ``shapes`` ((shape, scale), ...): f32, but the
    recurrent weights (the second) bf16."""
    args = [jnp.asarray((s * rng.standard_normal(x)).astype(np.float32))
            for x, s in shapes]
    args[1] = args[1].astype(jnp.bfloat16)
    return args


def _run_both(jfn, pfn, jargs, cots, backward_reference):
    """Outputs and all input gradients of the JAX and the port function
    under one random cotangent (the module docstring's bounds: tight up
    to T 16)."""
    short = cots[0].shape[1] <= 16

    def loss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(_flatten(jfn(*a)), cots))

    want = _flatten(jfn(*jargs))
    want_grads = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    leaves = [_torch(a).requires_grad_() for a in jargs]
    got = _flatten(pfn(*leaves))
    tcots = [torch.from_numpy(c) for c in cots]
    grads = torch.autograd.grad(got, leaves, tcots)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32  # the state stays f32
        np.testing.assert_allclose(g.detach().numpy(), _np(w),
                                   atol=ATOL if short else 5e-2)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), i
        err = np.abs(g.float().numpy() - _np(w)).max()
        scale = np.abs(_np(w)).max()
        if not short:
            assert err <= (0.3 if g.dtype == BF else 5e-2), i
        elif g.dtype == BF:
            assert err <= BF16_REL * scale, i
        else:
            assert err <= ATOL * max(1.0, scale), i
    # the plain backward alone gives the same gradients
    again = backward_reference([a.detach() for a in leaves], *tcots)
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    return grads


@pytest.mark.parametrize("t", [16, 37])
def test_plain_gru_bf16_matches_jax(t):
    rng = np.random.default_rng(t)
    b, h = 4, 32
    jargs = _jargs(rng, (((b, t, 3 * h), 0.5), ((h, 3 * h), 0.2),
                         ((3 * h,), 0.1), ((b, h), 0.1)))
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h))]
    before = K10.bf16_fwd_launches, K10.fwd_launches
    grads = _run_both(pallas_gru.gru_recurrence, K10.gru_recurrence, jargs,
                      cots, K10.gru_backward_reference)
    assert (K10.bf16_fwd_launches, K10.fwd_launches) == before  # CPU: plain
    assert [g.dtype for g in grads] == [torch.float32, BF, torch.float32,
                                        torch.float32]


@pytest.mark.parametrize("t", [16, 37])
def test_plain_lstm_recurrence_bf16_matches_jax(t):
    rng = np.random.default_rng(t + 1)
    b, h = 4, 32
    jargs = _jargs(rng, (((b, t, 4 * h), 0.5), ((h, 4 * h), 0.2),
                         ((b, h), 0.3), ((b, h), 0.3)))
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h), (b, h))]
    before = K8.bf16_fwd_launches, K8.fwd_launches
    grads = _run_both(pallas_lstm.lstm_recurrence, K8.lstm_recurrence,
                      jargs, cots, K8.lstm_recurrence_backward_reference)
    assert (K8.bf16_fwd_launches, K8.fwd_launches) == before  # CPU: plain
    assert [g.dtype for g in grads] == [torch.float32, BF, torch.float32,
                                        torch.float32]


@pytest.mark.parametrize("mod,name,dtype", [
    (K10, "xw", BF), (K10, "b_hh", BF), (K10, "h0", BF),
    (K8, "h0", BF), (K8, "xw", BF),
])
def test_bf16_recurrence_modes_refuse_other_mixes(mod, name, dtype):
    """Only all-f32 or bf16 ``w_hh_t`` with the rest f32 is a mode: the
    plain versions refuse any other mix, naming the kernel."""
    if mod is K10:
        t = dict(xw=torch.zeros(2, 3, 12), w_hh_t=torch.zeros(4, 12,
                                                                dtype=BF),
                 b_hh=torch.zeros(12), h0=torch.zeros(2, 4))
        fn, match = mod.gru_recurrence, "K10"
    else:
        t = dict(xw=torch.zeros(2, 3, 16), w_hh_t=torch.zeros(4, 16,
                                                                dtype=BF),
                 h0=torch.zeros(2, 4), c0=torch.zeros(2, 4))
        fn, match = mod.lstm_recurrence, "K8"
    t[name] = t[name].to(dtype)
    with pytest.raises(ValueError, match=match):
        fn(*t.values())


# ---- the modules with bf16 parameters ---------------------------------------

def _close_bf16(got, want, rel):
    g, w = got.detach().float().numpy(), _np(want)
    assert np.abs(g - w).max() <= rel * np.abs(w).max() + 1e-6


def _module_pair(jm, pm, x, x_dtype, seed):
    """(JAX outputs, parameter gradients; port outputs, gradients) of a
    module with bf16 parameters on the same input (in ``x_dtype``) and
    parameters."""
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pb = _cast_tree(params, jnp.bfloat16)
    xj = jnp.asarray(x).astype(x_dtype)

    def loss(p):
        outs = _flatten(jm.apply(p, xj))
        return (jnp.sum(outs[0].astype(jnp.float32) * 0.5)
                + sum(jnp.sum(o.astype(jnp.float32) ** 2) for o in outs[1:]))

    want = _flatten(jm.apply(pb, xj))
    jgrads = flat_params(jax.grad(loss)(pb))
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    pm.to(BF)
    got = _flatten(pm(_torch(xj)))
    ploss = (got[0].float() * 0.5).sum() + sum(
        (o.float() ** 2).sum() for o in got[1:])
    ploss.backward()
    return want, jgrads, got, {k: p.grad for k, p in pm.named_parameters()}


def _check_pair(want, jgrads, got, pgrads, dtype, rel=ROUTE_REL):
    for g, w in zip(got, want):
        assert g.dtype == dtype and str(w.dtype) == str(dtype).split(".")[-1]
        _close_bf16(g, w, rel)
    sd = state_dict_from_jax(jgrads)
    assert set(sd) == set(pgrads)
    for name, g in pgrads.items():
        assert g.dtype == BF, name
        _close_bf16(g, sd[name], 2e-2)


@pytest.mark.parametrize("route,t,x_dtype", [
    ("kernel", 24, "bfloat16"),   # K10's bf16 mode on bf16 input
    ("kernel", 17, "float32"),    # on f32 input (the later blocks')
    ("plain", 7, "bfloat16"),     # JAX's bf16 _gru_scan
])
def test_torch_gru_bf16_routes_match_jax(monkeypatch, route, t, x_dtype):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    assert recurrent.use_gru_kernel("cpu", t, 32) == (route == "kernel")
    din, h, layers = 24, 32, 2
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, din)).astype(np.float32)
    calls = []
    recurrence = K10.gru_recurrence

    def spy(*args):
        calls.append(tuple(a.dtype for a in args))
        return recurrence(*args)

    monkeypatch.setattr(K10, "gru_recurrence", spy)
    jm = JaxTorchGRU(input_size=din, hidden_size=h, num_layers=layers,
                     impl="pallas")
    pm = recurrent.TorchGRU(din, h, torch.Generator().manual_seed(0),
                            num_layers=layers)
    x_dt = getattr(jnp, x_dtype)
    pair = _module_pair(jm, pm, x, x_dt, seed=t)
    _check_pair(*pair, dtype=getattr(torch, x_dtype),
                rel=ROUTE_REL if route == "kernel" else SCAN_REL)
    f32 = torch.float32
    assert calls == ([(f32, BF, f32, f32)] * layers if route == "kernel"
                     else [])


@pytest.mark.parametrize("din,fused_dw", [(128, "0"), (24, "1")])
def test_torch_lstm_bf16_k8_route_matches_jax(monkeypatch, din, fused_dw):
    """K8's route in bf16: under MRGEN_FUSED_DW=0 (K7's route otherwise)
    and at an input size that is no multiple of 128 (K8's by default)."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_DW", fused_dw)
    h, t = 128, 17
    assert recurrent.single_layer_route("cpu", t, din, h) == \
        "lstm_recurrence"
    calls = []
    recurrence = K8.lstm_recurrence

    def spy(*args):
        calls.append(tuple(a.dtype for a in args))
        return recurrence(*args)

    monkeypatch.setattr(K8, "lstm_recurrence", spy)
    rng = np.random.default_rng(din)
    x = rng.standard_normal((2, t, din)).astype(np.float32)
    jm = JaxTorchLSTM(input_size=din, hidden_size=h, impl="pallas")
    pm = recurrent.TorchLSTM(din, h, torch.Generator().manual_seed(0))
    pair = _module_pair(jm, pm, x, jnp.bfloat16, seed=din)
    _check_pair(*pair, dtype=BF)
    f32 = torch.float32
    assert calls == [(f32, BF, f32, f32)]


# ---- the distance test's window -------------------------------------------

BF16_MODE_FRAC, MODE_STEPS = 0.25, 16  # chip_smoke.py's


@pytest.mark.parametrize("kernel", ["gru", "lstm_recurrence"])
def test_plain_bf16_recurrences_first_steps_hold_under_one_ulp(kernel):
    b, t, h = 32, 252, 256
    rng = np.random.default_rng(0)

    def r(*shape, s=1.0):
        return torch.from_numpy(
            (s * rng.standard_normal(shape)).astype(np.float32))

    if kernel == "gru":
        args = [r(b, t, 3 * h, s=.5), r(h, 3 * h, s=.06).to(BF),
                r(3 * h, s=.1), r(b, h, s=.3)]
        plain = lambda a: K10.gru_recurrence_reference(*a)[0]
    else:
        args = [r(b, t, 4 * h, s=.5), r(h, 4 * h, s=.06).to(BF),
                r(b, h, s=.3), r(b, h, s=.3)]
        plain = lambda a: K8.lstm_recurrence_reference(*a)[0]
    with torch.no_grad():
        ys, ys32 = plain(args), plain([a.float() for a in args])
        moved = plain([torch.nextafter(args[0], torch.tensor(np.inf)),
                       *args[1:]])
    w = slice(0, MODE_STEPS)
    gap = float((ys32[:, w] - ys[:, w]).abs().mean())
    assert float((moved[:, w] - ys[:, w]).abs().mean()) <= (
        0.1 * BF16_MODE_FRAC * gap)
