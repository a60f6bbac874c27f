"""PyTorch port: the LSTM layer and its dispatch vs the JAX package.

The port's plain ``lstm_layer`` (what CPU tensors run) vs the JAX
``ops/pallas_lstm.py lstm_layer`` with its Pallas calls in interpret mode
(patched as tests/test_pallas_lstm.py runs them): forward and the six
input gradients under one random cotangent, f32, atol 2e-5 (the JAX
kernel takes its sums in another order). ``TorchLSTM`` routes as the JAX
package does: under 16 steps the plain recurrence, from there on with
128-aligned sizes ``lstm_layer``; other sizes take ``lstm_recurrence``
(K8, tests/test_torch_port_lstm_recurrence.py). The CUDA kernels are held
to the plain version on the card in tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchLSTM as JaxTorchLSTM,
)
from multimodalreactiongeneration_tpu.ops import pallas_lstm
from multimodalreactiongeneration_tpu_torch.nn import recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(seed, b, t, din, h):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, din), (din, 4 * h), (4 * h,), (h, 4 * h), (b, h), (b, h)]
    args = [(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h), (b, h))]
    return args, cots


@pytest.mark.parametrize("t", [16, 37])
def test_plain_lstm_layer_matches_jax(t):
    args, cots = _inputs(t, 3, t, 24, 16)

    def loss(*a):
        ys, (hn, cn) = pallas_lstm.lstm_layer(*a)
        return sum(jnp.sum(o * c) for o, c in zip((ys, hn, cn), cots))

    jargs = [jnp.asarray(a) for a in args]
    ys, (hn, cn) = pallas_lstm.lstm_layer(*jargs)
    want_grads = jax.grad(loss, argnums=tuple(range(6)))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = K7.fwd_launches, K7.bwd_launches
    pys, (phn, pcn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad(
        (pys, phn, pcn), leaves, [torch.from_numpy(c) for c in cots])
    assert (K7.fwd_launches, K7.bwd_launches) == before  # CPU: plain
    for got, want in ((pys, ys), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
    names = ("dx", "dw_ih_t", "db_sum", "dw_hh_t", "dh0", "dc0")
    for got, want, name in zip(grads, want_grads, names):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)


def test_backward_reference_is_autograd_of_plain_forward():
    args, cots = _inputs(5, 2, 18, 16, 16)
    targs = [torch.from_numpy(a) for a in args]
    tcots = [torch.from_numpy(c) for c in cots]
    got = K7.lstm_layer_backward_reference(targs, *tcots)
    leaves = [a.clone().requires_grad_() for a in targs]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    want = torch.autograd.grad((ys, hn, cn), leaves, tcots)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_torchlstm_matches_jax_module_on_the_kernel_route():
    """At 128-aligned sizes over 20 steps both packages take the layer
    kernel's route (JAX: impl="pallas"); same weights, same result."""
    b, t, din, h = 2, 20, 128, 128
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((b, t, din))).astype(np.float32)
    mod = JaxTorchLSTM(input_size=din, hidden_size=h, num_layers=1,
                       impl="pallas")
    params = mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ys, (hn, cn) = mod.apply(params, jnp.asarray(x))

    port = recurrent.TorchLSTM(din, h, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(params["params"][name])))
    pys, (phn, pcn) = port(torch.from_numpy(x))
    for got, want in ((pys, ys), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


@pytest.mark.parametrize("t,din,h,routed", [
    (20, 128, 128, True),    # in the gate: lstm_layer
    (15, 128, 128, False),   # decode-sized: the plain recurrence
    (20, 18, 128, False),    # off the gate: K8, plain on CPU
])
def test_torchlstm_dispatch_on_cpu(monkeypatch, t, din, h, routed):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return K7.lstm_layer(*args)

    monkeypatch.setattr(recurrent, "lstm_layer", spy)
    port = recurrent.TorchLSTM(din, h, torch.Generator().manual_seed(1))
    x = torch.randn(2, t, din, generator=torch.Generator().manual_seed(2))
    ys, (hn, cn) = port(x)
    assert len(calls) == int(routed)
    want, (wh, wc) = K7.lstm_layer_reference(
        x, port.weight_ih_l0.T, port.bias_ih_l0 + port.bias_hh_l0,
        port.weight_hh_l0.T, torch.zeros(2, h), torch.zeros(2, h))
    torch.testing.assert_close(ys, want)
    torch.testing.assert_close(hn[0], wh)


def test_cuda_lstm_off_the_kernel_gate_raises():
    """Where the JAX package runs lstm_recurrence (K8), the port runs its
    K8 kernels; on the card a hidden size they do not take raises rather
    than quietly run the Python loop there."""
    route = recurrent.single_layer_route
    assert route("cuda", 252, 256, 256) == "lstm_layer"
    assert route("cuda", 15, 18, 256) == "plain"
    assert route("cpu", 252, 18, 256) == "lstm_recurrence"
    assert route("cuda", 252, 18, 256) == "lstm_recurrence"
    assert route("cpu", 252, 18, 64) == "lstm_recurrence"
    assert route("cuda", 252, 18, 64) == "lstm_recurrence"
    with pytest.raises(NotImplementedError, match="lstm_recurrence"):
        route("cuda", 252, 18, 384)
