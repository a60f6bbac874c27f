"""PyTorch port: the LSTM recurrence over precomputed inputs (K8) and the
bidirectional ``TorchLSTM`` vs the JAX package, on CPU tensors.

  * ``ops/lstm_recurrence.py lstm_recurrence`` (its plain version on the
    CPU) vs JAX ``ops/pallas_lstm.py lstm_recurrence`` with its Pallas
    calls in interpret mode, as ``tests/test_pallas_lstm.py`` runs it, at
    T 20 and 37 (not multiples of 16): forward atol 1e-5, the four
    gradients (dxw, dW_hh^T, dh0, dc0) atol 2e-4 (that file's tolerances);
  * ``TorchLSTM`` bidirectional, one and two layers, states included, vs
    JAX ``TorchLSTM`` on its scan route and on its Pallas route (interpret
    mode) under both ``MRGEN_FUSED_DW`` values, with parameter gradients;
    ``LSTMLayerd`` bidirectional with the new states;
  * the single-layer routing decision (plain / K7 / K8) under both
    ``MRGEN_FUSED_DW`` values, aligned and unaligned sizes, by device
    type, with no card; and that the module takes the route it names.
The CUDA kernels are held to the plain version in
``tests/test_torch_port_kernels.py`` (on a card) and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.nn import lstm_block as jblock
from multimodalreactiongeneration_tpu.nn.recurrent import TorchLSTM as JaxLSTM
from multimodalreactiongeneration_tpu.ops import pallas_lstm
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import lstm_block, recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed, b=4, t=37, h=32):
    """The shapes and scales of tests/test_pallas_lstm.py _setup, from
    numpy: xw (B, T, 4H), W_hh^T (H, 4H), h0, c0 (B, H), and cotangents."""
    rng = np.random.default_rng(seed)
    xw = 0.5 * rng.standard_normal((b, t, 4 * h))
    w_hh_t = 0.2 * rng.standard_normal((h, 4 * h))
    h0, c0 = 0.1 * rng.standard_normal((2, b, h))
    cots = (rng.standard_normal((b, t, h)), rng.standard_normal((b, h)),
            rng.standard_normal((b, h)))
    f32 = lambda a: a.astype(np.float32)
    return [f32(a) for a in (xw, w_hh_t, h0, c0)], [f32(c) for c in cots]


@pytest.mark.parametrize("t", [20, 37])
def test_lstm_recurrence_matches_jax_kernel(interpret, t):
    args, cots = _inputs(t, t=t)
    jargs = [jnp.asarray(a) for a in args]
    (ys, (hn, cn)), vjp = jax.vjp(pallas_lstm.lstm_recurrence, *jargs)
    want_grads = vjp((jnp.asarray(cots[0]),
                      (jnp.asarray(cots[1]), jnp.asarray(cots[2]))))

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    calls = K8.fwd_launches, K8.bwd_launches
    pys, (phn, pcn) = K8.lstm_recurrence(*leaves)
    grads = torch.autograd.grad((pys, phn, pcn), leaves,
                                [torch.from_numpy(c) for c in cots])
    assert (K8.fwd_launches, K8.bwd_launches) == calls  # CPU: plain
    for got, want in ((pys, ys), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    for got, want, name in zip(grads, want_grads,
                               ("dxw", "dwhh", "dh0", "dc0")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=name)


def test_lstm_recurrence_backward_reference_is_autograd_of_plain():
    args, cots = _inputs(3, b=3, t=5, h=8)
    targs = [torch.from_numpy(a) for a in args]
    tcots = [torch.from_numpy(c) for c in cots]
    once = K8.lstm_recurrence_backward_reference(targs, *tcots)
    again = K8.lstm_recurrence_backward_reference(targs, *tcots,
                                                  closure=True)
    for a, b in zip(once, again()):
        assert torch.equal(a, b)
    assert [tuple(g.shape) for g in once] == [tuple(a.shape) for a in args]


def _lstm_pair(layers, din, h, seed):
    jmod = JaxLSTM(input_size=din, hidden_size=h, num_layers=layers,
                   bidirectional=True)
    x = np.random.default_rng(seed).standard_normal((3, 20, din)).astype(
        np.float32)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pmod = recurrent.TorchLSTM(din, h, torch.Generator().manual_seed(0),
                               num_layers=layers, bidirectional=True)
    pmod.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    return jmod, params, pmod, x


@pytest.mark.parametrize("layers,din,h,impl,fused_dw", [
    (1, 12, 16, "scan", "1"),
    (2, 12, 16, "scan", "1"),
    (1, 12, 16, "pallas", "1"),    # JAX: K8 (unaligned sizes)
    (2, 12, 16, "pallas", "0"),    # JAX: K8 under MRGEN_FUSED_DW=0
])
def test_bidirectional_torchlstm_matches_jax(interpret, monkeypatch, layers,
                                             din, h, impl, fused_dw):
    """Outputs, states (L * 2, B, H) in torch's layer-major order, and the
    gradients of every parameter and of x, T 20 from given states."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", impl)
    monkeypatch.setenv("MRGEN_FUSED_DW", fused_dw)
    jmod, params, pmod, x = _lstm_pair(layers, din, h, layers * 10 + din)
    rng = np.random.default_rng(1)
    hx = [0.3 * rng.standard_normal((2 * layers, 3, h)).astype(np.float32)
          for _ in range(2)]
    w = rng.standard_normal((3, 20, 2 * h)).astype(np.float32)
    wh, wc = rng.standard_normal((2, 2 * layers, 3, h)).astype(np.float32)

    def jloss(p, x):
        ys, (hn, cn) = jmod.apply(p, x, tuple(jnp.asarray(s) for s in hx))
        return (jnp.sum(ys * w) + jnp.sum(hn * wh) + jnp.sum(cn * wc),
                (ys, hn, cn))

    (_, (ys, hn, cn)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    pys, (phn, pcn) = pmod(tx, tuple(torch.from_numpy(s) for s in hx))
    assert phn.shape == (2 * layers, 3, h)
    loss = ((pys * torch.from_numpy(w)).sum() + (phn * torch.from_numpy(wh))
            .sum() + (pcn * torch.from_numpy(wc)).sum())
    loss.backward()
    for got, want in ((pys, ys), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4)
    want = state_dict_from_jax(flat_params(gp))
    for name, p in pmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-4, err_msg=name)


def test_bidirectional_state_order_is_layer_major():
    """State k * 2 + d is layer k, direction d: the reverse direction's
    h_n is its state after the FIRST frame (it reads the sequence back to
    front)."""
    pmod = recurrent.TorchLSTM(5, 4, torch.Generator().manual_seed(2),
                               num_layers=2, bidirectional=True)
    x = torch.randn(2, 6, 5, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ys, (hn, cn) = pmod(x)
    assert ys.shape == (2, 6, 8) and hn.shape == cn.shape == (4, 2, 4)
    np.testing.assert_allclose(hn[2].numpy(), ys[:, -1, :4].numpy())
    np.testing.assert_allclose(hn[3].numpy(), ys[:, 0, 4:].numpy())
    assert "weight_ih_l1_reverse" in dict(pmod.named_parameters())
    assert pmod.weight_ih_l1.shape == (16, 8)


@pytest.mark.parametrize("use_mixing", [False, True])
def test_bidirectional_lstm_layerd_matches_jax(use_mixing):
    """Two bidirectional blocks with the FFN, T 18, then 4 steps from the
    new states."""
    kw = dict(input_size=32, lstm_hidden_size=16, affine_hidden_size=32,
              bottleneck_size=8, num_layers=2, num_layers_per_block=1,
              output_size=32, bidirectional=True, use_mixing=use_mixing)
    jmod = jblock.LSTMLayerd(**kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 18, 32)).astype(np.float32)
    x2 = rng.standard_normal((2, 4, 32)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))
    y, st = jmod.apply(params, jnp.asarray(x))
    y2, st2 = jmod.apply(params, jnp.asarray(x2), st)

    pmod = lstm_block.LSTMLayerd(generator=torch.Generator().manual_seed(0),
                                 **kw)
    pmod.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    with torch.no_grad():
        py, pst = pmod(torch.from_numpy(x))
        py2, pst2 = pmod(torch.from_numpy(x2), pst)
    for got, want in ((py, y), (py2, y2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for got, want in ((pst, st), (pst2, st2)):
        for (gh, gc), (wh, wc) in zip(got, want):
            assert gh.shape == (2, 2, 16)
            np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-5)
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=1e-5)


@pytest.mark.parametrize("fused_dw", ["1", "0", None])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_single_layer_route(monkeypatch, fused_dw, device):
    """The JAX route (nn/recurrent.py:248-302) by device type, without a
    card: the plain recurrence under 16 steps; K7 with MRGEN_FUSED_DW on
    (the default) and 128-aligned sizes; K8 otherwise; on CUDA a hidden
    size K8 does not take raises, naming K8."""
    if fused_dw is None:
        monkeypatch.delenv("MRGEN_FUSED_DW", raising=False)
    else:
        monkeypatch.setenv("MRGEN_FUSED_DW", fused_dw)
    on = fused_dw != "0"
    route = recurrent.single_layer_route
    assert route(device, 15, 256, 128) == "plain"
    assert route(device, 15, 18, 64) == "plain"
    assert route(device, 120, 256, 128) == ("lstm_layer" if on
                                            else "lstm_recurrence")
    assert route(device, 252, 256, 256) == ("lstm_layer" if on
                                            else "lstm_recurrence")
    assert route(device, 120, 81, 128) == "lstm_recurrence"
    assert route(device, 16, 18, 256) == "lstm_recurrence"
    if device == "cuda":
        for h in (320, 384):
            with pytest.raises(NotImplementedError, match="K8"):
                route(device, 16, 18, h)
    else:
        assert route(device, 16, 18, 64) == "lstm_recurrence"


@pytest.mark.parametrize("fused_dw,din,want", [
    ("1", 128, "lstm_layer"), ("0", 128, "lstm_recurrence"),
    ("1", 81, "lstm_recurrence"),
])
def test_torchlstm_calls_the_routed_op(monkeypatch, fused_dw, din, want):
    """Each direction of a bidirectional layer over 16 steps calls the op
    its route names, once, with contiguous f32 operands (the reverse one
    on the flipped input); under 16 steps neither is called."""
    monkeypatch.setenv("MRGEN_FUSED_DW", fused_dw)
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            assert all(a.dtype == torch.float32 and a.is_contiguous()
                       for a in args)
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(recurrent, "lstm_layer",
                        spy("lstm_layer", recurrent.lstm_layer))
    monkeypatch.setattr(recurrent.k8, "lstm_recurrence",
                        spy("lstm_recurrence", K8.lstm_recurrence))
    pmod = recurrent.TorchLSTM(din, 128, torch.Generator().manual_seed(0),
                               bidirectional=True)
    x = torch.randn(1, 16, din, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ys, _ = pmod(x)
        assert calls == [want, want]
        ref = recurrent.lstm_layer_reference(
            torch.flip(x, [1]), *pmod._layer(0, reverse=True),
            torch.zeros(1, 128), torch.zeros(1, 128))[0]
        np.testing.assert_allclose(ys[..., 128:].numpy(),
                                   torch.flip(ref, [1]).numpy(), atol=1e-6)
        pmod(x[:, :15])
    assert calls == [want, want]
