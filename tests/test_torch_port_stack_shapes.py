"""PyTorch port: the encoder stack (K1/K3/K4) at every hidden size up to
512 and the LSTM layer (K7) at 384 and 512, on CPU tensors against the
JAX package.

The stack's kernels are built for multiples of their cluster size (8 CTAs
to H 256, 16 from 257 to 512) from 128 on (``ops/mixer_stack.py
stack_hidden``); any other H runs on the next such width, its arguments
zero-padded (``pad_args``) and the LayerNorms given the real width. JAX's stack
kernel takes any H (it pads time only). Here, with JAX's Pallas calls in
interpret mode:

  * the padded route: the arguments padded, the plain version at the
    padded width with the real width, the outputs cut back, against the
    plain version at the real width (forward and all twelve gradients,
    f32 within 1e-6, abs up to magnitude 1 and of the largest magnitude
    past it: the same sums over zeros more, in another blocking) and
    against JAX's ``mixer_stack_recurrence`` at the bounds of
    tests/test_torch_port_mixer_stack.py (2e-5; gradients 2e-5 of their
    largest past magnitude 1). A size the kernels are built for runs
    unpadded on the card; there the test pads to the next built width, so
    the padding's arithmetic is held at every size. H in {1, 48, 100, 192,
    200, 300, 384, 448, 512}, B 2-3, T 20, L 2;
  * the bf16 operand mode the same way, padded against plain and against
    JAX (compiled with ``xla_allow_excess_precision`` off), at the bounds
    the bf16 stack's tests hold past T 16 (tests/test_torch_port_kernels.py
    ``_bf16_within``, chip_smoke.py ``BF16_FULL_TOL``: 5e-2 abs on the
    outputs, 5e-2 of their largest on every gradient): the three round the
    same operands to bf16 and sum in f32 in other orders, so an h or a
    block input on a bf16 rounding boundary rounds the other way in one of
    them and the LayerNorms after it move their rows, and the backward's
    cotangents, rounded to bf16 at each product, differ by a bf16 ulp
    where two sums straddle a boundary (read: outputs up to 3.8e-3 abs,
    gradients up to 5.3e-3 of their largest, at H 100 to 512); and the
    output on average within ``BF16_MODE_FRAC`` of the plain f32
    version's distance from the plain bf16 one (read at most 0.11): a
    version that took f32 operands reads 1;
  * the routes: ``kernel_refusal`` takes every H from 1 to 512; past it
    the CUDA routes raise naming K1/K3/K4 or K7 and the CPU routes take
    it; the padded arguments and outputs are 0 at every padded unit.

K7 at 384 and 512 and the hidden-48 LSTM-mixer Metaformer are in
tests/test_torch_port_stack_models.py. The CUDA kernels at these shapes
are held to their plain versions on the card in
tests/test_torch_port_kernels.py and chip_smoke.py phase 41.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_mixer_stack as jstack
from multimodalreactiongeneration_tpu_torch.nn import mixers, recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack as K1
from tests.test_torch_port_kernel_shapes import (
    _close_padded,
    _jax_vjp,
    _np,
    _torch,
)

torch.set_num_threads(1)
BF = torch.bfloat16
ATOL = 2e-5                      # tests/test_torch_port_mixer_stack.py
BF16_STACK_TOL = (5e-2, 5e-2, 5e-2)  # chip_smoke.BF16_FULL_TOL
BF16_MODE_FRAC = 0.25                # chip_smoke.BF16_MODE_FRAC
STACK_HIDDEN = [1, 48, 100, 192, 200, 300, 384, 448, 512]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _pad_width(h):
    """The width the card runs H at or, where H is built, H and one more
    cluster's worth of units (past 512 only the plain version runs)."""
    hp = K1.stack_hidden(h)
    return hp if hp != h else h + K1.cluster_ctas(h)


def _stack_inputs(h, b=3, t=20, n=2):
    """Numpy arguments and cotangents of an n-block stack of width h."""
    rng = np.random.default_rng(h)

    def r(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    w = h ** -0.5  # torch's LSTM init scale: pre-activations O(1)
    args = [r(b, t, h), r(n, h, 4 * h, s=w), r(n, 4 * h, s=0.1),
            r(n, h, 4 * h, s=w), r(n, h, h, s=w), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3)]
    cots = [r(b, t, h), r(n, b, h), r(n, b, h)]
    return args, cots


def _padded_stack(h, hp):
    """What the card runs at hidden size h padded to hp: the arguments
    padded, the plain version there at the real width, the outputs cut
    back."""
    def run(*args):
        out, (hn, cn) = K1.mixer_stack_forward_reference(
            *K1.pad_args(args, hp), real=h)
        out, hn, cn = K1.unpad_outputs(out, hn, cn, h)
        return out, (hn, cn)
    return run


def _torch_grads(fn, leaves, cots):
    """fn's (out, hn, cn), detached, and the twelve gradients."""
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    out, (hn, cn) = fn(*leaves)
    grads = torch.autograd.grad((out, hn, cn), leaves,
                                [torch.from_numpy(c) for c in cots])
    return [o.detach() for o in (out, hn, cn)], grads


def _stack_case(h, bf16):
    """(padded route, plain route, JAX) outputs and gradients at h."""
    args, cots = _stack_inputs(h, b=2 if h > 256 else 3)
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        for i in K1._WEIGHTS:
            jargs[i] = jargs[i].astype(jnp.bfloat16)
    leaves = [_torch(a) for a in jargs]
    padded = _torch_grads(_padded_stack(h, _pad_width(h)), leaves, cots)
    plain = _torch_grads(K1.mixer_stack_forward_reference, leaves, cots)
    want = _jax_vjp(jstack.mixer_stack_recurrence, jargs, cots)
    return padded, plain, want


def _close_scaled(got, want, tol, err_msg=""):
    """Within tol abs up to magnitude 1, tol of the largest past it."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w,
                               atol=tol * max(1.0, np.abs(w).max()),
                               err_msg=err_msg)


@pytest.mark.parametrize("h", STACK_HIDDEN)
def test_stack_padding_f32_is_exact_and_matches_jax(h):
    (outs, grads), (pouts, pgrads), (jouts, jgrads) = _stack_case(h, False)
    _close_padded(list(outs) + list(grads), list(pouts) + list(pgrads))
    for i, (g, w) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=ATOL,
                                   err_msg=str(i))
    for i, (g, w) in enumerate(zip(grads, jgrads)):
        _close_scaled(g, w, ATOL, str(i))


@pytest.mark.parametrize("h", STACK_HIDDEN)
def test_stack_padding_bf16_matches_plain_and_jax(h):
    (outs, grads), (pouts, pgrads), (jouts, jgrads) = _stack_case(h, True)
    args, _ = _stack_inputs(h, b=2 if h > 256 else 3)
    with torch.no_grad():
        y32 = K1.mixer_stack_forward_reference(
            *[torch.from_numpy(a) for a in args])[0]
    gap = float((y32 - pouts[0]).abs().mean())
    for want, wgrads in ((pouts, pgrads),
                         ([_torch(x) for x in jouts],
                          [_torch(x) for x in jgrads])):
        for g, w in zip(outs, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       atol=BF16_STACK_TOL[0])
        for i, (g, w) in enumerate(zip(grads, wgrads)):
            assert g.dtype == w.dtype, i
            err = float((g.float() - w.float()).abs().max())
            bound = BF16_STACK_TOL[2 if g.dtype == BF else 1] * float(
                w.float().abs().max())
            assert err <= bound, (i, err, bound)
        dist = float((outs[0] - want[0]).abs().mean())
        assert dist <= BF16_MODE_FRAC * gap or dist == gap == 0.0


def test_stack_padded_units_stay_zero_and_arguments_pad_with_zeros():
    """Every padded argument (the LayerNorms' scales and shifts too) is 0
    at every padded unit and its real units unchanged; the plain version
    at the real width keeps the padded units of its output and states 0,
    and their gradients, cut back, are the real ones."""
    h, hp = 3, 8
    args, cots = _stack_inputs(h, b=2, t=17)
    targs = [torch.from_numpy(a) for a in args]
    padded = K1.pad_args(targs, hp)
    gate = lambda x: x.reshape(*x.shape[:-1], 4, -1)  # noqa: E731
    for i, (a, p) in enumerate(zip(targs, padded)):
        if i in (1, 3):  # W^T (L, H, 4H): rows and each gate block
            real = gate(p)[:, :h, :, :h]
            assert torch.equal(real, gate(a)), i
            assert not gate(p)[:, h:].any() and not gate(p)[..., h:].any(), i
        elif i == 2:  # b_g (L, 4H)
            assert torch.equal(gate(p)[..., :h], gate(a)), i
            assert not gate(p)[..., h:].any(), i
        elif i == 4:  # W_ff (L, H, H)
            assert torch.equal(p[:, :h, :h], a), i
            assert not p[:, h:].any() and not p[..., h:].any(), i
        else:
            assert torch.equal(p[..., :h], a), i
            assert not p[..., h:].any(), i
        assert p.shape[-1] == (4 * hp if i in (1, 2, 3) else hp), i
    out, (hn, cn) = K1.mixer_stack_forward_reference(*padded, real=h)
    for x in (out, hn, cn):
        assert not x[..., h:].any()
    assert K1.unpad_outputs(out, hn, cn, h)[0].shape == (2, 17, h)


# ---- the routes -----------------------------------------------------------

def test_stack_kernels_take_every_hidden_size_up_to_512():
    for h in range(1, K1.MAX_H + 1):
        assert K1.kernel_refusal(h) is None, h
        hp = K1.stack_hidden(h)
        assert h <= hp <= K1.MAX_H and hp % K1.cluster_ctas(hp) == 0, h
        assert 16 <= hp // K1.cluster_ctas(hp) <= 32, h
        assert hp - max(h, K1.MIN_H) < K1.cluster_ctas(hp), h
        mixers.require_stack_kernel("cuda", 2, 64, h)
    assert [K1.stack_hidden(h) for h in (1, 100, 136, 192, 257, 300, 512)] == [
        128, 128, 136, 192, 272, 304, 512]


@pytest.mark.parametrize("h", [128, 256, 384, 512])
def test_lstm_layer_route_takes_128_aligned_sizes_up_to_512(h):
    assert K7.kernel_refusal(h, h) is None
    assert recurrent.single_layer_route("cuda", 16, h, h) == "lstm_layer"


def test_cuda_routes_raise_naming_the_kernels_above_512():
    with pytest.raises(NotImplementedError, match="K1/K3/K4"):
        mixers.require_stack_kernel("cuda", 5, 2096, 640)
    with pytest.raises(NotImplementedError, match="K7"):
        recurrent.single_layer_route("cuda", 16, 640, 640)
    assert "K1/K3/K4" in K1.kernel_refusal(513)
    assert "K1/K3/K4" in K1.kernel_refusal(0)
    assert "K7" in K7.kernel_refusal(640, 640)
    assert "K7" in K7.kernel_refusal(192, 192)
    # the wrappers' own checks on tensors off the CPU
    x = torch.zeros(1, 16, 640, device="meta")
    with pytest.raises(ValueError, match="K1/K3/K4"):
        K1.mixer_stack_forward(x, *([x] * 11))
    # the CPU routes take them (the plain versions)
    mixers.require_stack_kernel("cpu", 5, 2096, 640)
    assert recurrent.single_layer_route("cpu", 16, 640, 640) == "lstm_layer"
