"""PyTorch port: the stacked-LSTM wavefront (K9) and its dispatch vs the
JAX package.

The port's plain ``lstm_stacked_recurrence`` (what CPU tensors run) vs
the JAX ``ops/pallas_lstm_stacked.py lstm_stacked_recurrence`` with its
Pallas calls in interpret mode (patched as tests/test_pallas_lstm_stacked.py
runs them), forward and all six input gradients under one random
cotangent, f32: forward atol 2e-5, gradients atol 3e-4 (the JAX test's
bound: the kernel takes its sums in another order), at 2, 3 and 4
layers (4: past the wavefront, K9's layer route on the card). The layer
route's host plan (its window, the route a stack takes) and its window
schedule emulated in torch against the plain stack. ``TorchLSTM`` with
2 and 3 layers vs the JAX ``TorchLSTM(impl="pallas")`` in interpret mode:
outputs, (L, B, H) states and the gradients of input and parameters.
Dispatch as the JAX package: under 16 steps the plain recurrence layer by
layer, from there on the stacked path; on CUDA a stack the kernels do
not take raises; a bidirectional LSTM, and active dropout between layers
in training, run layer by layer (dropout draws its masks only inside
``nn.basic.dropout_rng``). The CUDA kernels are held to the plain version on
the card in tests/test_torch_port_kernels.py.
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
from multimodalreactiongeneration_tpu.ops import pallas_lstm_stacked
from multimodalreactiongeneration_tpu_torch.nn import recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from tests.test_pallas_lstm_stacked import _scan_stack_ref

torch.set_num_threads(1)
FWD_ATOL, GRAD_ATOL = 2e-5, 3e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(seed, b, t, h, layers):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, 4 * h), (layers - 1, h, 4 * h), (layers - 1, 4 * h),
              (layers, h, 4 * h), (layers, b, h), (layers, b, h)]
    scales = [0.5, 0.2, 0.1, 0.2, 0.1, 0.1]
    args = [(s * rng.standard_normal(x)).astype(np.float32)
            for x, s in zip(shapes, scales)]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (layers, b, h), (layers, b, h))]
    return args, cots


@pytest.mark.parametrize("layers,t", [(2, 16), (3, 21), (4, 18)])
def test_plain_lstm_stacked_matches_jax(layers, t):
    args, cots = _inputs(t, 3, t, 16, layers)
    jargs = [jnp.asarray(a) for a in args]

    def loss(*a):
        ys, (hn, cn) = pallas_lstm_stacked.lstm_stacked_recurrence(*a)
        return sum(jnp.sum(o * c) for o, c in zip((ys, hn, cn), cots))

    ys, (hn, cn) = pallas_lstm_stacked.lstm_stacked_recurrence(*jargs)
    want_grads = jax.grad(loss, argnums=tuple(range(6)))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = K9.fwd_launches, K9.bwd_launches
    pys, (phn, pcn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad(
        (pys, phn, pcn), leaves, [torch.from_numpy(c) for c in cots])
    assert (K9.fwd_launches, K9.bwd_launches) == before  # CPU: plain
    for got, want in ((pys, ys), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=FWD_ATOL)
    names = ("dxw0", "dw_ih_t", "db_rest", "dw_hh_t", "dh0", "dc0")
    for got, want, name in zip(grads, want_grads, names):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, err_msg=name)


def test_plain_lstm_stacked_single_step_matches_layer_by_layer():
    """T = 1: layer l's only valid wavefront slot is l."""
    args, _ = _inputs(2, 3, 1, 16, 4)
    ys, (hn, cn) = K9.lstm_stacked_reference(
        *[torch.from_numpy(a) for a in args])
    want = _scan_stack_ref(*[jnp.asarray(a) for a in args])
    for got, w in zip((ys, hn, cn), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=FWD_ATOL)


def test_backward_reference_is_autograd_of_plain_forward():
    args, cots = _inputs(5, 2, 18, 16, 3)
    targs = [torch.from_numpy(a) for a in args]
    tcots = [torch.from_numpy(c) for c in cots]
    got = K9.lstm_stacked_backward_reference(targs, *tcots)
    again = K9.lstm_stacked_backward_reference(targs, *tcots, closure=True)()
    leaves = [a.clone().requires_grad_() for a in targs]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    want = torch.autograd.grad((ys, hn, cn), leaves, tcots)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def _port_lstm(params, din, h, layers):
    port = recurrent.TorchLSTM(din, h, torch.Generator().manual_seed(0),
                               num_layers=layers)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(params["params"][name])))
    return port


@pytest.mark.parametrize("layers", [2, 3])
def test_torchlstm_stack_matches_jax_module(layers):
    """Both packages take the stacked route (JAX impl="pallas", T 20);
    same weights, inputs and states: the same outputs, (L, B, H) states
    and gradients of the input and every parameter."""
    b, t, din, h = 3, 20, 12, 16
    rng = np.random.default_rng(layers)
    x = (0.5 * rng.standard_normal((b, t, din))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((layers, b, h))).astype(np.float32)
    c0 = (0.1 * rng.standard_normal((layers, b, h))).astype(np.float32)
    mod = JaxTorchLSTM(input_size=din, hidden_size=h, num_layers=layers,
                       impl="pallas")
    params = mod.init(jax.random.PRNGKey(layers), jnp.asarray(x))

    def jloss(p, xx):
        ys, (hn, cn) = mod.apply(p, xx, (jnp.asarray(h0), jnp.asarray(c0)))
        return jnp.sum(ys ** 2) + jnp.sum(hn) + jnp.sum(cn * 0.5), (ys, hn,
                                                                      cn)

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(x))
    port = _port_lstm(params, din, h, layers)
    xt = torch.from_numpy(x).requires_grad_()
    ys, (hn, cn) = port(xt, (torch.from_numpy(h0), torch.from_numpy(c0)))
    assert hn.shape == cn.shape == (layers, b, h)
    for got, w in zip((ys, hn, cn), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w),
                                   atol=FWD_ATOL)
    (ys.square().sum() + hn.sum() + (cn * 0.5).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp["params"][name]),
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("t,stacked", [(16, True), (15, False)])
def test_torchlstm_stack_dispatch_on_cpu(monkeypatch, t, stacked):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return K9.lstm_stacked_recurrence(*args)

    monkeypatch.setattr(recurrent, "lstm_stacked_recurrence", spy)
    port = recurrent.TorchLSTM(8, 16, torch.Generator().manual_seed(1),
                               num_layers=2)
    x = torch.randn(2, t, 8, generator=torch.Generator().manual_seed(2))
    ys, (hn, cn) = port(x)
    assert len(calls) == int(stacked)
    # either route computes the layer-by-layer recurrence
    want, (wh, wc) = K9.lstm_stacked_reference(
        x @ port.weight_ih_l0.T + port.bias_ih_l0 + port.bias_hh_l0,
        port.weight_ih_l1.T[None], (port.bias_ih_l1 + port.bias_hh_l1)[None],
        torch.stack([port.weight_hh_l0.T, port.weight_hh_l1.T]),
        torch.zeros(2, 2, 16), torch.zeros(2, 2, 16))
    torch.testing.assert_close(ys, want)
    torch.testing.assert_close(hn, wh)
    torch.testing.assert_close(cn, wc)


def test_stack_gate_raises_on_cuda_for_shapes_the_kernel_does_not_take():
    """K9 takes hidden 128 at 2-3 layers on its wavefront and every other
    hidden size up to 256 (any depth; 128 past 3 layers) on its layer
    route; hidden sizes above 256 raise on CUDA, naming the sizes it
    takes."""
    assert recurrent.use_lstm_stacked("cuda", 1120, 2, 128, 256)
    assert recurrent.use_lstm_stacked("cuda", 16, 3, 128, 12)
    assert recurrent.use_lstm_stacked("cuda", 96, 2, 256, 2)
    assert recurrent.use_lstm_stacked("cuda", 96, 4, 128, 2)
    assert not recurrent.use_lstm_stacked("cuda", 15, 2, 256, 2)
    assert not recurrent.use_lstm_stacked("cuda", 96, 1, 128, 2)
    assert recurrent.use_lstm_stacked("cpu", 96, 2, 16, 2)
    with pytest.raises(NotImplementedError, match="hidden size 384"):
        recurrent.use_lstm_stacked("cuda", 96, 2, 384, 2)
    assert [K9.route(l, h) for l, h in ((2, 128), (3, 128), (4, 128),
                                        (2, 256), (5, 256), (2, 384))] == [
        "wavefront", "wavefront", "layers", "layers", "layers", None]


def test_layer_route_plan():
    """The layer route's window (``layers_chunk``: 64, 128 past 1,024
    steps, capped at T) and the route each stack takes on CUDA."""
    assert [K9.layers_chunk(t) for t in (1, 37, 64, 252, 1024, 1025, 2016,
                                         2096)] == [1, 37, 64, 64, 64, 128,
                                                    128, 128]
    assert K9.kernel_refusal(1, 128, 2) == "1 layers: a stack has 2 or more"
    assert K9.kernel_refusal(2, 256, 2) is None
    assert K9.kernel_refusal(4, 128, 2) is None


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_layer_route_windows_emulated_match_plain(chunk):
    """The layer route's schedule in torch: layer l's window c from its
    input product over the window's rows and the state the window before
    left, after layer l - 1's window c; equals the plain stack (and so
    JAX's) for any window length, a ragged last window included."""
    args, _ = _inputs(11, 3, 45, 16, 3)
    xw0, w_ih_t, b_rest, w_hh_t, h0, c0 = [torch.from_numpy(a) for a in args]
    layers, t = w_hh_t.shape[0], xw0.shape[1]
    outs = [torch.zeros(3, t, 16) for _ in range(layers)]
    state = [(h0[l], c0[l]) for l in range(layers)]
    for t0 in range(0, t, chunk):
        win = slice(t0, min(t, t0 + chunk))
        for l in range(layers):
            x = (xw0[:, win] if l == 0
                 else outs[l - 1][:, win] @ w_ih_t[l - 1] + b_rest[l - 1])
            ys, state[l] = recurrent.k8.lstm_recurrence_reference(
                x, w_hh_t[l], *state[l])
            outs[l][:, win] = ys
    want, (hn, cn) = K9.lstm_stacked_reference(xw0, w_ih_t, b_rest, w_hh_t,
                                               h0, c0)
    torch.testing.assert_close(outs[-1], want, rtol=0, atol=FWD_ATOL)
    torch.testing.assert_close(torch.stack([s[0] for s in state]), hn,
                               rtol=0, atol=FWD_ATOL)
    torch.testing.assert_close(torch.stack([s[1] for s in state]), cn,
                               rtol=0, atol=FWD_ATOL)


def test_torchlstm_refuses_bidirectional_and_dropout_in_training(
        monkeypatch):
    """Dropout between layers in training draws its masks only inside
    ``dropout_rng`` (raises outside it), one direction or two, and runs
    the stack layer by layer (JAX's ``dropout == 0 or deterministic``
    gate); a bidirectional stack runs layer by layer and direction by
    direction, never the stacked route (JAX takes it for one direction
    only)."""
    from multimodalreactiongeneration_tpu_torch.nn.basic import dropout_rng

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 20, 8, generator=gen)
    monkeypatch.setattr(recurrent, "lstm_stacked_recurrence", None)
    for bidirectional in (False, True):
        port = recurrent.TorchLSTM(8, 16, gen, num_layers=2, dropout=0.1,
                                   bidirectional=bidirectional)
        with pytest.raises(RuntimeError, match="dropout_rng"):
            port(x)
        with dropout_rng(0):
            ys, _ = port(x)
        assert ys.shape == (2, 20, 16 * (2 if bidirectional else 1))
    port.eval()
    ys, (hn, cn) = port(x)
    assert ys.shape == (2, 20, 32) and hn.shape == (4, 2, 16)
    port = recurrent.TorchLSTM(8, 16, gen, num_layers=2, dropout=0.1).eval()
    monkeypatch.undo()
    ys, (hn, cn) = port(x)  # inactive dropout: the stacked route, as in JAX
    assert ys.shape == (2, 20, 16) and hn.shape == (2, 2, 16)
