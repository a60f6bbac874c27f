"""PyTorch port: each CUDA kernel vs its plain PyTorch version, on a card.

Marked ``cuda``; every test skips without a CUDA device (the kernels
have no CPU mode). The file imports no JAX, so it also runs on a machine
without it: ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_kernels.py -q``. Tolerances: f32 kernel vs f32
plain version 1e-4 (sums in another order through a long recurrence).
"""

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu_torch.ops import (
    decode_rollout as K2,
    mixer_stack as K1,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,layers", [(16, 40, 3), (3, 17, 2), (20, 33, 5)])
def test_mixer_stack_kernel_matches_plain(dev, b, t, layers):
    h = 256
    rng = np.random.default_rng(b * t)

    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    n = layers
    args = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))
    before = K1.launches
    y, (hn, cn) = K1.mixer_stack_forward(*args)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    for got, want in ((y, yr), (hn, hr), (cn, cr)):
        assert float((got - want).abs().max()) <= TOL


def test_mixer_stack_kernel_refuses_bf16_weights(dev):
    x = torch.zeros(2, 16, 256, device=dev)
    w = torch.zeros(1, 256, 1024, device=dev, dtype=torch.bfloat16)
    z = torch.zeros(1, 256, device=dev)
    s = torch.zeros(1, 2, 256, device=dev)
    with pytest.raises(ValueError, match="f32"):
        K1.mixer_stack_forward(x, w, torch.zeros(1, 1024, device=dev), w,
                               torch.zeros(1, 256, 256, device=dev), z, z, z,
                               z, z, s, s)


@pytest.mark.parametrize("batch", [16, 18])
@pytest.mark.parametrize("mode", ["teacher", "full"])
def test_decode_rollout_kernel_matches_plain(dev, batch, mode):
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    model = Metaformer(LSTMFORMER_MODEL_CFG,
                       generator=torch.Generator().manual_seed(0), device=dev)
    frames, lead, ratio = 6, 12, 8
    rng = np.random.default_rng(batch)
    shapes = [(batch, frames * ratio, 81), (batch, frames, 18),
              (batch, frames, 18), (batch, lead * ratio, 81),
              (batch, lead, 18), (batch, lead, 18), (batch, frames, 18)]
    data = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in shapes]
    mask = G.sampling_mask_for(frames, mode, device=dev)
    with torch.no_grad():
        states, ea, em, ms, la, lm = G._hoist_and_warmup(
            model, data, torch.float32)
        args, kw = G._fused_rollout_args(
            model, states, ea, em, ms, mask, torch.float32, la, lm)
        before = K2.launches
        got = K2.decode_rollout(*args, **kw)
        torch.cuda.synchronize()
        assert K2.launches == before + (batch + 15) // 16
        want = K2.decode_rollout_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


def _rand(rng, dev):
    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    return r


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


GRAD_REL_TOL = 1e-3  # max|kernel - plain| / max|plain| (split-K sums)


@pytest.mark.parametrize("b,t,h,layers", [(16, 40, 256, 3), (20, 33, 128, 2)])
def test_mixer_stack_train_kernels_match_plain(dev, b, t, h, layers):
    r = _rand(np.random.default_rng(b * t + h), dev)
    n = layers
    args = (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))
    cots = (r(b, t, h), r(n, b, h), r(n, b, h))
    leaves = [a.clone().requires_grad_() for a in args]
    counts = K1.launches, K1.train_fwd_launches, K1.bwd_launches
    y, (hn, cn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad((y, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K1.launches, K1.train_fwd_launches, K1.bwd_launches) == (
        counts[0], counts[1] + 1, counts[2] + 1)
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    for got, want in ((y, yr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    want = K1.mixer_stack_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert float(w.abs().max()) > 0, i
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def test_mixer_stack_recurrence_without_grad_runs_inference_kernel(dev):
    r = _rand(np.random.default_rng(3), dev)
    b, t, h, n = 4, 20, 128, 2
    args = (r(b, t, h), *[r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
                          r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06)],
            *[r(n, h, s=0.1) for _ in range(5)], r(n, b, h), r(n, b, h))
    before = K1.launches, K1.train_fwd_launches
    K1.mixer_stack_recurrence(*args)
    assert (K1.launches, K1.train_fwd_launches) == (before[0] + 1, before[1])


def _stack_args(r, b, t, h, n):
    return (r(b, t, h), r(n, h, 4 * h, s=0.06), r(n, 4 * h, s=0.06),
            r(n, h, 4 * h, s=0.06), r(n, h, h, s=0.06), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))


@pytest.mark.parametrize("b,t,layers,chunk", [
    (16, 2096, 5, 32), (32, 252, 5, 8), (17, 37, 2, 8), (3, 40, 3, 1),
    (33, 101, 5, 64), (64, 300, 5, 16), (5, 37, 1, 10)])
def test_mixer_stack_chunks_bitwise_equal_layer_major(dev, b, t, layers,
                                                      chunk):
    """The chunk schedule gives the bits of chunk=T (the layer-major
    schedule): out, hn, cn, and every residual plane of the training
    forward; one launch counted per wrapper call."""
    r = _rand(np.random.default_rng(b + t + chunk), dev)
    args = _stack_args(r, b, t, 256, layers)
    with torch.no_grad():
        before = K1.launches, K1.train_fwd_launches
        got = K1.mixer_stack_forward(*args, chunk=chunk)
        want = K1.mixer_stack_forward(*args, chunk=t)
        got_tr = K1.mixer_stack_train_forward(*args, chunk=chunk)
        want_tr = K1.mixer_stack_train_forward(*args, chunk=t)
        torch.cuda.synchronize()
        assert (K1.launches, K1.train_fwd_launches) == (before[0] + 2,
                                                        before[1] + 2)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert torch.equal(g, w)
    # out, hn, cn, and every residual plane (the top block keeps none for
    # its output)
    assert got_tr[3].numel() == (9 * layers - 1) * got[0].numel()
    for g, w in zip(got_tr, want_tr):
        assert torch.equal(g, w)
    assert torch.equal(got_tr[0], got[0])


@pytest.mark.parametrize("b,t,layers", [
    (1, 37, 1), (17, 37, 2), (33, 37, 5), (64, 37, 5), (1, 2016, 5),
    (17, 2016, 1), (33, 2016, 2), (64, 2016, 5)])
def test_mixer_stack_schedule_matches_plain(dev, b, t, layers):
    """Both forwards at the chunk chunk_steps picks vs the plain
    version."""
    r = _rand(np.random.default_rng(7 * b + t + layers), dev)
    args = _stack_args(r, b, t, 256, layers)
    with torch.no_grad():
        y, (hn, cn) = K1.mixer_stack_forward(*args)
        y2, hn2, cn2, _ = K1.mixer_stack_train_forward(*args)
        yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    for got, want in ((y, yr), (hn, hr), (cn, cr), (y2, yr), (hn2, hr),
                      (cn2, cr)):
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("b,t,layers,chunk", [(32, 252, 5, 16),
                                              (17, 101, 3, 8)])
def test_mixer_stack_backward_from_chunked_residuals(dev, b, t, layers,
                                                     chunk):
    """K4 from the residuals of the chunk schedule's training forward vs
    the plain backward."""
    r = _rand(np.random.default_rng(b * chunk + t), dev)
    args = _stack_args(r, b, t, 256, layers)
    cots = (r(b, t, 256), r(layers, b, 256), r(layers, b, 256))
    before = K1.train_fwd_launches, K1.bwd_launches
    out, hn, cn, res = K1.mixer_stack_train_forward(*args, chunk=chunk)
    grads = K1.mixer_stack_backward(args, res, *cots)
    torch.cuda.synchronize()
    assert (K1.train_fwd_launches, K1.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    for got, want in ((out, yr), (hn, hr), (cn, cr)):
        assert float((got - want).abs().max()) <= TOL
    want = K1.mixer_stack_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def test_mixer_stack_refuses_chunks_it_does_not_take(dev):
    r = _rand(np.random.default_rng(1), dev)
    args = _stack_args(r, 2, 20, 128, 2)
    res = K1.mixer_stack_train_forward(*args)[3]
    cots = (r(2, 20, 128), r(2, 2, 128), r(2, 2, 128))
    before = K1.bwd_launches
    for kw in (dict(chunk=0), dict(chunk=21)):
        with pytest.raises(ValueError):
            K1.mixer_stack_forward(*args, **kw)
        with pytest.raises(ValueError):
            K1.mixer_stack_train_forward(*args, **kw)
        with pytest.raises(ValueError, match="mixer_stack_backward"):
            K1.mixer_stack_backward(args, res, *cots, **kw)
    assert K1.bwd_launches == before


@pytest.mark.parametrize("b,t,layers,chunk", [
    (1, 37, 1, 1), (17, 37, 2, 8), (33, 37, 5, 3), (64, 37, 5, 16),
    (17, 37, 5, 36), (1, 2016, 5, 64), (17, 2016, 1, 32), (33, 2016, 2, 64),
    (64, 2016, 5, 64), (64, 2016, 5, 37)])
def test_mixer_stack_backward_chunks_bitwise_equal_layer_major(
        dev, b, t, layers, chunk):
    """K4's reverse chunk schedule: dx0, dh0, dc0 the bits of chunk=T
    (the layer-major order); the nine parameter gradients within
    GRAD_REL_TOL of plain at both; two runs at one chunk the same bits;
    one launch counted per wrapper call."""
    r = _rand(np.random.default_rng(3 * b + t + layers + chunk), dev)
    args = _stack_args(r, b, t, 256, layers)
    cots = (r(b, t, 256), r(layers, b, 256), r(layers, b, 256))
    res = K1.mixer_stack_train_forward(*args)[3]
    before = K1.bwd_launches
    got = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    again = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    whole = K1.mixer_stack_backward(args, res, *cots, chunk=t)
    torch.cuda.synchronize()
    assert K1.bwd_launches == before + 3
    for i in (0, 10, 11):  # dx0, dh0, dc0
        assert torch.equal(got[i], whole[i]), i
    for i, (g, w) in enumerate(zip(got, again)):
        assert torch.equal(g, w), i
    want = K1.mixer_stack_backward_reference(args, *cots)
    for i, (g, gw, w) in enumerate(zip(got, whole, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i
        assert _rel_err(gw, w) <= GRAD_REL_TOL, i


@pytest.mark.parametrize("b,t,din,h", [(16, 40, 256, 256), (5, 17, 128, 128)])
def test_lstm_layer_kernels_match_plain(dev, b, t, din, h):
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    r = _rand(np.random.default_rng(b * t + din), dev)
    args = (r(b, t, din), r(din, 4 * h, s=0.06), r(4 * h, s=0.06),
            r(h, 4 * h, s=0.06), r(b, h, s=0.3), r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    ysr, (hr, cr) = K7.lstm_layer_reference(*args)
    before = K7.fwd_launches, K7.bwd_launches
    ys, (hn, cn) = K7.lstm_layer(*args)  # no grad needed: no residuals
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K7.fwd_launches, K7.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    want = K7.lstm_layer_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def test_training_kernels_refuse_bf16_and_off_gate_shapes(dev):
    from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
        single_layer_route,
    )
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    b, t = 2, 16
    # K7 takes 128-aligned H to 512, the stack any H to 512
    for h, dt, match, k7_match in (
            (256, torch.bfloat16, "f32", "f32"),
            (640, torch.float32, "K1/K3/K4", "multiples of 128 up to 512")):
        w = torch.zeros(h, 4 * h, device=dev, dtype=dt)
        s = torch.zeros(b, h, device=dev)
        # K7 takes bf16 x and weights with an f32 b_sum (its bf16 mode);
        # a bf16 b_sum is no mode of it
        with pytest.raises(ValueError, match=k7_match):
            K7.lstm_layer(torch.zeros(b, t, h, device=dev, dtype=dt), w,
                          torch.zeros(4 * h, device=dev, dtype=dt), w, s, s)
        args = (torch.zeros(b, t, h, device=dev, dtype=dt),
                w[None].requires_grad_(), torch.zeros(1, 4 * h, device=dev),
                w[None], torch.zeros(1, h, h, device=dev),
                *[torch.zeros(1, h, device=dev)] * 5,
                torch.zeros(1, b, h, device=dev),
                torch.zeros(1, b, h, device=dev))
        with pytest.raises(ValueError, match=match):
            K1.mixer_stack_recurrence(*args)  # K3/K4
        with torch.no_grad(), pytest.raises(ValueError, match=match):
            K1.mixer_stack_recurrence(*args)  # K1
    with pytest.raises(NotImplementedError, match="K8"):
        single_layer_route("cuda", 16, 18, 384)
    with pytest.raises(ValueError, match="K7"):
        z = torch.zeros(b, 64, device=dev)
        K7.lstm_layer(torch.zeros(b, t, 64, device=dev),
                      torch.zeros(64, 256, device=dev),
                      torch.zeros(256, device=dev),
                      torch.zeros(64, 256, device=dev), z, z)


@pytest.mark.parametrize("b,t,layers", [
    (3, 16, 2), (20, 17, 3), (5, 1, 3), (16, 96, 2), (256, 1120, 2),
])
def test_lstm_stacked_kernels_match_plain(dev, b, t, layers):
    """K9 forward without and with residuals, and backward, vs plain, from
    small ragged shapes (T 1, 16, 17; batch not a multiple of 16) to the
    lws sampler's (B16 x T96 generation warmup, B256 x T1120 training)."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    h = 128
    r = _rand(np.random.default_rng(b * t + layers), dev)
    args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06),
            r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    ysr, (hr, cr) = K9.lstm_stacked_reference(*args)
    before = K9.fwd_launches, K9.bwd_launches
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*args)  # no grad: no residuals
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K9.fwd_launches, K9.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    want = K9.lstm_stacked_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def _assert_within_gates(got, want, n_fwd):
    """The first ``n_fwd`` tensors within TOL abs, the rest (gradients)
    within GRAD_REL_TOL of their largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        if i < n_fwd:
            assert float((g.detach() - w).abs().max()) <= TOL, i
        else:
            assert _rel_err(g, w) <= GRAD_REL_TOL, i


@pytest.mark.parametrize("b,t,layers", [
    (241, 1, 2), (256, 1, 2), (257, 1, 2), (241, 1120, 2), (256, 1120, 2),
    (257, 1120, 2), (256, 64, 3),
])
def test_lstm_stacked_chosen_rows_match_rows16(dev, b, t, layers):
    """K9 at the rows per cluster the wrapper chooses (ragged last
    clusters at R 24 and 32 for B241 and B257) equals K9 at R 16 within
    the gates, and both hold against the plain version; L3 keeps R 16.
    The wrapper launches as before: +2 forwards, +1 backward."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    h = 128
    r = _rand(np.random.default_rng(b * t + layers), dev)
    args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06),
            r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    chosen = K9.rows_for(dev, layers, False, b), K9.rows_for(dev, layers,
                                                            True, b)
    for backward, rows in enumerate(chosen):
        resident, _ = K9.layout(dev.index or 0, layers, bool(backward))
        if layers == 3:
            assert rows == 16
        else:
            assert -(-b // rows) <= resident[rows], (rows, resident)
    before = K9.fwd_launches, K9.bwd_launches
    ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K9.fwd_launches, K9.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    chosen_out = (ys0, hn0, cn0, ys, hn, cn, *grads)
    ys16, hn16, cn16, hs, acts, cs = K9.lstm_stacked_forward(args, True,
                                                             rows=16)
    ys16n, hn16n, cn16n, *_ = K9.lstm_stacked_forward(args, False, rows=16)
    grads16 = K9.lstm_stacked_backward(args[1:], ys16, hs, acts, cs, *cots,
                                       rows=16)
    rows16_out = (ys16n, hn16n, cn16n, ys16, hn16, cn16, *grads16)
    _assert_within_gates(chosen_out, rows16_out, 6)
    ysr, (hr, cr) = K9.lstm_stacked_reference(*args)
    want = (ysr, hr, cr, ysr, hr, cr,
            *K9.lstm_stacked_backward_reference(args, *cots))
    _assert_within_gates(chosen_out, want, 6)
    _assert_within_gates(rows16_out, want, 6)


@pytest.mark.parametrize("b,t", [(256, 140), (250, 17)])
def test_lstm_layer_chosen_rows_match_rows16(dev, b, t):
    """K7 at lstm_with_sampling's block shape (256 -> 256) and a ragged
    batch: the wrapper's rows per cluster equal R 16 within the gates and
    both hold against the plain version; +2 forwards, +1 backward."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    din = h = 256
    r = _rand(np.random.default_rng(b * t), dev)
    args = (r(b, t, din), r(din, 4 * h, s=0.06), r(4 * h, s=0.06),
            r(h, 4 * h, s=0.06), r(b, h, s=0.3), r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    for backward in (False, True):
        rows = K7.rows_for(dev, h, backward, b)
        resident, _ = K7.layout(dev.index or 0, h, backward)
        assert -(-b // rows) <= resident[rows], (rows, resident)
    before = K7.fwd_launches, K7.bwd_launches
    ys0, (hn0, cn0) = K7.lstm_layer(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K7.fwd_launches, K7.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    chosen_out = (ys0, hn0, cn0, ys, hn, cn, *grads)
    ys16, hn16, cn16, acts, cs = K7.lstm_layer_forward(args, True, rows=16)
    ys16n, hn16n, cn16n, _, _ = K7.lstm_layer_forward(args, False, rows=16)
    grads16 = K7.lstm_layer_backward(args, ys16, acts, cs, *cots, rows=16)
    rows16_out = (ys16n, hn16n, cn16n, ys16, hn16, cn16, *grads16)
    _assert_within_gates(chosen_out, rows16_out, 6)
    ysr, (hr, cr) = K7.lstm_layer_reference(*args)
    want = (ysr, hr, cr, ysr, hr, cr,
            *K7.lstm_layer_backward_reference(args, *cots))
    _assert_within_gates(chosen_out, want, 6)
    _assert_within_gates(rows16_out, want, 6)


# bf16 modes (K7, K9) vs their plain bf16 versions: the two round h and
# the dgates to bf16 at the same products but sum in other orders, so a
# value on a rounding boundary can round the other way (at B250 x T17 x
# H256 some ten h of 10^6 flip, and move their rows' gates by ~1e-4). At
# a short T a flip has little room to compound: forward 1e-3 abs, the
# f32 gradients 2e-3 and the bf16 ones 1e-2 of their largest magnitude
# (one bf16 ulp is 2^-8 to 2^-7 of a value). Over the lws lengths the JAX
# bf16 bound (tests/test_pallas_lstm.py:130) holds: 5e-2 abs on outputs
# and states, and 5e-2 of their largest magnitude on the gradients (sums
# over 10^4 to 10^5 rows: a dW of 200 has a bf16 ulp of 1). And the
# kernel's ys lies on average at most a quarter as far from the plain
# bf16 version's as the plain f32 version's does: a kernel that took
# f32 operands would not (the flips are too rare to move the mean).
BF16_SHORT = (1e-3, 2e-3, 1e-2)


def _mode_distance(ys, want_ys, ys_f32, mode_steps=None):
    """The mean distance of ys from the plain bf16 ys over the first
    ``mode_steps`` steps (all without), over the plain f32 ys' distance
    from them: a kernel that took f32 operands reads about 1."""
    w = slice(None) if mode_steps is None else slice(0, mode_steps)
    gap = float((ys_f32[:, w] - want_ys[:, w]).abs().mean())
    return float((ys.detach()[:, w] - want_ys[:, w]).abs().mean()) / gap


def _bf16_within(outs, grads, want_outs, want_grads, short, ys_f32=None,
                 mode_steps=None, mode_frac=0.25):
    if ys_f32 is not None:
        assert _mode_distance(outs[0], want_outs[0], ys_f32,
                              mode_steps) <= mode_frac
    for g, w in zip(outs, want_outs):
        assert float((g.detach() - w).abs().max()) <= (
            BF16_SHORT[0] if short else 5e-2)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert g.dtype == w.dtype, i
        tol = (BF16_SHORT[2 if g.dtype == torch.bfloat16 else 1] if short
               else 5e-2)
        assert _rel_err(g.float(), w.float()) <= tol, i


@pytest.mark.parametrize("b,t,din,h", [
    (16, 40, 256, 256), (5, 17, 128, 128), (250, 17, 256, 256),
    (256, 140, 256, 256),
])
def test_lstm_layer_bf16_kernels_match_plain_bf16(dev, b, t, din, h):
    """K7's bf16 mode (bf16 x and weights, f32 b_sum and states) vs the
    plain bf16 version: forward with and without residuals, backward;
    dx, dW_ih and dW_hh come back bf16; +2 / +1 bf16 launches."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    r = _rand(np.random.default_rng(b * t + din), dev)
    bf = torch.bfloat16
    args = (r(b, t, din).to(bf), r(din, 4 * h, s=0.06).to(bf),
            r(4 * h, s=0.06), r(h, 4 * h, s=0.06).to(bf), r(b, h, s=0.3),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    ysr, (hr, cr) = K7.lstm_layer_reference(*args)
    before = (K7.fwd_launches, K7.bwd_launches, K7.bf16_fwd_launches,
              K7.bf16_bwd_launches)
    ys0, (hn0, cn0) = K7.lstm_layer(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K7.fwd_launches, K7.bwd_launches, K7.bf16_fwd_launches,
            K7.bf16_bwd_launches) == (*before[:2], before[2] + 2,
                                      before[3] + 1)
    ys32, _ = K7.lstm_layer_reference(*[a.float() for a in args])
    _bf16_within((ys0, hn0, cn0, ys, hn, cn), grads,
                 (ysr, hr, cr) * 2, K7.lstm_layer_backward_reference(
                     args, *cots), short=t <= 40, ys_f32=ys32)


@pytest.mark.parametrize("b,t,layers", [
    (3, 16, 2), (20, 17, 3), (5, 1, 3), (241, 33, 2), (16, 96, 2),
    (256, 1120, 2),
])
def test_lstm_stacked_bf16_kernels_match_plain_bf16(dev, b, t, layers):
    """K9's bf16 mode (bf16 weights, f32 xw0, b_rest and states) vs the
    plain bf16 version, from ragged shapes to the lws sampler's B256 x
    T1120; dW come back bf16, dxw0 f32; +2 / +1 bf16 launches."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    h = 128
    r = _rand(np.random.default_rng(b * t + layers), dev)
    bf = torch.bfloat16
    args = (r(b, t, 4 * h), r(layers - 1, h, 4 * h, s=0.06).to(bf),
            r(layers - 1, 4 * h, s=0.06), r(layers, h, 4 * h, s=0.06).to(bf),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    ysr, (hr, cr) = K9.lstm_stacked_reference(*args)
    before = K9.bf16_fwd_launches, K9.bf16_bwd_launches
    ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K9.bf16_fwd_launches, K9.bf16_bwd_launches) == (
        before[0] + 2, before[1] + 1)
    ys32, _ = K9.lstm_stacked_reference(*[a.float() for a in args])
    _bf16_within((ys0, hn0, cn0, ys, hn, cn), grads,
                 (ysr, hr, cr) * 2, K9.lstm_stacked_backward_reference(
                     args, *cots), short=t <= 40, ys_f32=ys32)


def _bf16_stack_args(r, b, t, h, n):
    """The encoder stack's bf16 mode: W_ih, W_hh and W_ff bf16."""
    args = list(_stack_args(r, b, t, h, n))
    for i in K1._WEIGHTS:
        args[i] = args[i].to(torch.bfloat16)
    return tuple(args)


@pytest.mark.parametrize("b,t,h,layers", [
    (4, 16, 128, 2), (16, 40, 256, 3), (20, 33, 128, 2), (3, 17, 256, 5),
    (32, 252, 256, 5),
])
def test_mixer_stack_bf16_kernels_match_plain_bf16(dev, b, t, h, layers):
    """K3/K4's bf16 mode (bf16 W_ih, W_hh and W_ff; the rest f32) vs the
    plain bf16 version: forward and all twelve gradients; dW_ih, dW_hh
    and dW_ff come back bf16, the rest f32; +1 / +1 bf16 launches and no
    f32 ones; K1's bf16 mode (no gradient) gives the training forward's
    bits (the same schedule, without the residual stores), +1 bf16
    inference launch. The
    short bounds hold to T16: past it an h or a block input on a bf16
    rounding boundary rounds the other way in one of them (the sums run
    in other orders) and moves the rows after it by ~1e-4 (6.5e-3 at
    most at B16 x T40 x L3), so the full-length bounds hold there; to T40
    over up to 3 layers the kernel's outputs are on average within a
    quarter of the plain f32 version's distance from the plain bf16 ones.
    Deeper and longer stacks decorrelate from the plain bf16 version as
    fast as the plain bf16 version does from a 1e-7 perturbation of its
    own input (0.59 of the f32 distance at B8 x T252 x L5), so there that
    test reads the first 4 steps, before a flip compounds through the
    layers (tests/test_torch_port_bf16_flagship.py)."""
    r = _rand(np.random.default_rng(b * t + h + layers), dev)
    args = _bf16_stack_args(r, b, t, h, layers)
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    names = ("launches", "train_fwd_launches", "bwd_launches",
             "bf16_train_fwd_launches", "bf16_bwd_launches")
    before = [getattr(K1, n) for n in names]
    leaves = [a.clone().requires_grad_() for a in args]
    y, (hn, cn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad((y, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert [getattr(K1, n) for n in names] == [*before[:3], before[3] + 1,
                                                before[4] + 1]
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    want = K1.mixer_stack_backward_reference(args, *cots)
    y32 = K1.mixer_stack_forward_reference(*[a.float() for a in args])[0]
    # the distance test over the steps before a flip compounds
    _bf16_within((y, hn, cn), grads, (yr, hr, cr), want, short=t <= 16,
                 ys_f32=y32,
                 mode_steps=None if layers <= 3 and t <= 40 else 4)
    before = K1.bf16_launches
    with torch.no_grad():
        yi, (hi, ci) = K1.mixer_stack_recurrence(*args)
    torch.cuda.synchronize()
    assert K1.bf16_launches == before + 1
    for got, want in ((yi, y), (hi, hn), (ci, cn)):
        assert torch.equal(got, want.detach())


@pytest.mark.parametrize("b,t,layers,chunk", [
    (17, 37, 2, 8), (33, 37, 5, 3), (32, 252, 5, 16), (64, 2016, 5, 37)])
def test_mixer_stack_bf16_chunks_bitwise_equal_layer_major(dev, b, t, layers,
                                                           chunk):
    """The bf16 mode keeps the chunk schedule's bits: the training forward
    (out, hn, cn, every residual plane) and K4's dx0, dh0, dc0 at any
    chunk are the bits of chunk=T; two backward runs at one chunk the
    same bits."""
    r = _rand(np.random.default_rng(5 * b + t + layers + chunk), dev)
    args = _bf16_stack_args(r, b, t, 256, layers)
    cots = (r(b, t, 256), r(layers, b, 256), r(layers, b, 256))
    got_tr = K1.mixer_stack_train_forward(*args, chunk=chunk)
    want_tr = K1.mixer_stack_train_forward(*args, chunk=t)
    for g, w in zip(got_tr, want_tr):
        assert torch.equal(g, w)
    res = got_tr[3]
    got = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    again = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    whole = K1.mixer_stack_backward(args, res, *cots, chunk=t)
    torch.cuda.synchronize()
    for i in (0, 10, 11):  # dx0, dh0, dc0
        assert torch.equal(got[i], whole[i]), i
    for i, (g, w) in enumerate(zip(got, again)):
        assert torch.equal(g, w), i
    for i in K1._WEIGHTS:
        assert got[i].dtype == torch.bfloat16, i


@pytest.mark.parametrize("b,t,h,layers,chunk", [
    (4, 16, 128, 2, 5), (17, 37, 256, 2, 8), (16, 262, 256, 5, None),
    (16, 2096, 256, 5, None)])
def test_mixer_stack_bf16_inference_matches_plain_bf16(dev, b, t, h, layers,
                                                       chunk):
    """K1's bf16 mode (``mixer_stack_forward`` on bf16 W_ih, W_hh, W_ff):
    at any chunk the bits of chunk=T and of the training forward; within
    the short bounds of the plain bf16 version to T16 and the full-length
    ones past it (as K3's bf16 mode: a rounding flip moves the rows after
    it, 4.6e-3 at B17 x T37 x L2) and, over its first 4 steps at depth,
    within a quarter of the plain f32 version's distance; +1 bf16 launch
    a call, none in f32."""
    r = _rand(np.random.default_rng(7 * b + t + h + layers), dev)
    args = _bf16_stack_args(r, b, t, h, layers)
    before = K1.launches, K1.bf16_launches
    got = K1.mixer_stack_forward(*args, chunk=chunk)
    whole = K1.mixer_stack_forward(*args, chunk=t)
    train = K1.mixer_stack_train_forward(*args)
    torch.cuda.synchronize()
    assert (K1.launches, K1.bf16_launches) == (before[0], before[1] + 2)
    y, (hn, cn) = got
    for g, w, tr in zip((y, hn, cn), (whole[0], *whole[1]), train[:3]):
        assert torch.equal(g, w) and torch.equal(g, tr)
    want = K1.mixer_stack_forward_reference(*args)
    y32 = K1.mixer_stack_forward_reference(*[a.float() for a in args])[0]
    _bf16_within((y, hn, cn), (), (want[0], *want[1]), (), short=t <= 16,
                 ys_f32=y32,
                 mode_steps=None if layers <= 3 and t <= 40 else 4)


def test_lstm_chains_refuse_rows_they_do_not_take(dev):
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    z = lambda *s: torch.zeros(*s, device=dev)
    h, b, t = 128, 4, 3
    with pytest.raises(ValueError, match="20 rows"):
        K7.lstm_layer_forward((z(b, t, h), z(h, 4 * h), z(4 * h),
                               z(h, 4 * h), z(b, h), z(b, h)), False, rows=20)
    with pytest.raises(ValueError, match="24 rows"):
        K9.lstm_stacked_forward((z(b, t, 4 * h), z(2, h, 4 * h),
                                 z(2, 4 * h), z(3, h, 4 * h), z(3, b, h),
                                 z(3, b, h)), False, rows=24)


def test_lstm_stacked_kernel_refuses_other_shapes(dev):
    """K9 takes hidden 128 at 2-3 layers on the wavefront and hidden 256
    (any depth) or 128 past 3 layers on the layer route; other hidden
    sizes, one layer, bf16 states and rows per cluster on the layer route
    raise, naming K9's refusal."""
    from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
        use_lstm_stacked,
    )
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    b, t = 2, 16
    for layers, h, dt, match in ((2, 384, torch.float32, "hidden size 384"),
                                 (1, 128, torch.float32, "1 layers"),
                                 (2, 128, torch.bfloat16, "f32")):
        z = lambda *s: torch.zeros(*s, device=dev, dtype=dt)
        args = (z(b, t, 4 * h), z(layers - 1, h, 4 * h), z(layers - 1, 4 * h),
                z(layers, h, 4 * h), z(layers, b, h), z(layers, b, h))
        with pytest.raises(ValueError, match=match):
            K9.lstm_stacked_recurrence(*args)
    z = lambda *s: torch.zeros(*s, device=dev)
    h = 256
    with pytest.raises(ValueError, match="no rows per cluster"):
        K9.lstm_stacked_forward((z(b, t, 4 * h), z(1, h, 4 * h), z(1, 4 * h),
                                 z(2, h, 4 * h), z(2, b, h), z(2, b, h)),
                                False, rows=16)
    with pytest.raises(NotImplementedError, match="hidden size 384"):
        use_lstm_stacked("cuda", 16, 2, 384, b)
    assert use_lstm_stacked("cuda", 16, 2, 64, b)
    assert use_lstm_stacked("cuda", 16, 2, 128, b)
    assert use_lstm_stacked("cuda", 16, 2, 256, b)
    assert use_lstm_stacked("cuda", 16, 4, 128, b)


def _stacked_args(r, b, t, h, layers, bf16=False):
    """K9's inputs (xw0, w_ih_t, b_rest, w_hh_t, h0, c0) and cotangents;
    with ``bf16`` the weights bf16 (the bf16 operand mode)."""
    w = (lambda a: a.to(torch.bfloat16)) if bf16 else (lambda a: a)
    args = (r(b, t, 4 * h), w(r(layers - 1, h, 4 * h, s=0.06)),
            r(layers - 1, 4 * h, s=0.06), w(r(layers, h, 4 * h, s=0.06)),
            r(layers, b, h, s=0.3), r(layers, b, h, s=0.3))
    return args, (r(b, t, h), r(layers, b, h), r(layers, b, h))


def _stacked_counts(K9):
    return (K9.fwd_launches, K9.bwd_launches, K9.bf16_fwd_launches,
            K9.bf16_bwd_launches, K9.layers_fwd_launches,
            K9.layers_bwd_launches, K9.layers_bf16_fwd_launches,
            K9.layers_bf16_bwd_launches)


@pytest.mark.parametrize("b,t,h,layers", [
    (3, 16, 256, 2), (20, 37, 256, 3), (5, 17, 128, 4), (16, 96, 128, 4),
    (32, 252, 256, 2), (32, 2016, 256, 2),
])
def test_lstm_stacked_layer_route_matches_plain(dev, b, t, h, layers):
    """K9's layer route (hidden 256, and hidden 128 past 3 layers) vs the
    plain version: the forward without residuals (no grad), the forward
    with them and the backward, within K9's bounds, to the Metaformer's
    audio encoder (B32 x T2016 x H256 x L2); exactly +2 / +1 launches of
    the route's own counters, none of the wavefront's."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    assert K9.route(layers, h) == "layers"
    args, cots = _stacked_args(_rand(np.random.default_rng(b * t + h), dev),
                               b, t, h, layers)
    before = _stacked_counts(K9)
    ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert _stacked_counts(K9) == (*before[:4], before[4] + 2,
                                   before[5] + 1, *before[6:])
    ysr, (hr, cr) = K9.lstm_stacked_reference(*args)
    want = (ysr, hr, cr, ysr, hr, cr,
            *K9.lstm_stacked_backward_reference(args, *cots))
    _assert_within_gates((ys0, hn0, cn0, ys, hn, cn, *grads), want, 6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t,h,layers,chunk", [
    (3, 37, 256, 2, 16), (20, 33, 256, 3, 7), (5, 40, 128, 4, 13),
    (32, 252, 256, 2, 64), (17, 130, 256, 2, 1),
])
def test_lstm_stacked_layer_route_windows_give_whole_sequence_bits(
        dev, b, t, h, layers, chunk, bf16):
    """The layer route's lagged windows (ragged last windows, windows of
    one step) give the bits of ``chunk = T`` (the layers one after the
    other): forward without and with residuals, every residual, and the
    backward; run to run the same bits."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    args, cots = _stacked_args(_rand(np.random.default_rng(b + t), dev),
                               b, t, h, layers, bf16)
    got, whole = [], []
    for c, out in ((chunk, got), (t, whole), (chunk, got)):
        fwd0 = K9.lstm_stacked_forward(args, False, chunk=c)
        fwd = K9.lstm_stacked_forward(args, True, chunk=c)
        grads = K9.lstm_stacked_backward(args[1:], fwd[0], *fwd[3:], *cots,
                                         chunk=c)
        out.append([x for x in (*fwd0[:3], *fwd, *grads) if x is not None])
    for a, w, again in zip(got[0], whole[0], got[1]):
        assert torch.equal(a, w) and torch.equal(a, again)


@pytest.mark.parametrize("b,t,h,layers", [
    (3, 16, 256, 2), (20, 37, 256, 3), (5, 17, 128, 4), (32, 252, 256, 2),
    (32, 2016, 256, 2),
])
def test_lstm_stacked_layer_route_bf16_matches_plain_bf16(dev, b, t, h,
                                                          layers):
    """The layer route's bf16 mode (bf16 weights, f32 xw0, b_rest and
    states) vs the plain bf16 version, within K9's bf16 bounds (a long
    chain's distance test over its first 16 steps, where a rounding flip
    has not compounded); dW come back bf16; +2 / +1 bf16 launches of the
    route's counters."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    args, cots = _stacked_args(_rand(np.random.default_rng(b * t + h), dev),
                               b, t, h, layers, bf16=True)
    before = _stacked_counts(K9)
    ys0, (hn0, cn0) = K9.lstm_stacked_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K9.lstm_stacked_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert _stacked_counts(K9) == (*before[:6], before[6] + 2, before[7] + 1)
    ysr, (hr, cr) = K9.lstm_stacked_reference(*args)
    ys32, _ = K9.lstm_stacked_reference(*[a.float() for a in args])
    _bf16_within((ys0, hn0, cn0, ys, hn, cn), grads,
                 (ysr, hr, cr) * 2, K9.lstm_stacked_backward_reference(
                     args, *cots), short=t <= 40, ys_f32=ys32,
                 mode_steps=None if t <= 40 else 16)


def _rect_inputs(dev, seed, b, lq, lk, e, full_row=True):
    """q/k/v (B, L, E) and pads with ~10% padded rows and keys; with
    ``full_row``, row 3 of batch 0 has every key masked (it and the keys
    it can see are padding)."""
    rng = np.random.default_rng(seed)
    r = _rand(rng, dev)
    q_pad = torch.from_numpy(rng.random((b, lq)) < 0.1)
    k_pad = torch.from_numpy(rng.random((b, lk)) < 0.1)
    if full_row:
        q_pad[0, 3] = True
        k_pad[0, :-(-4 * lk // lq)] = True
    return (r(b, lq, e), r(b, lk, e), r(b, lk, e), q_pad.to(dev),
            k_pad.to(dev), r(b, lq, e))


@pytest.mark.parametrize("b,lq,lk,e,heads", [
    (32, 252, 2016, 256, 4), (32, 252, 252, 256, 4), (2, 16, 128, 64, 2),
    (2, 128, 16, 64, 2), (3, 40, 40, 128, 2), (2, 10, 20, 64, 2),
])
def test_rect_attention_kernels_match_plain(dev, b, lq, lk, e, heads):
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    q, k, v, q_pad, k_pad, g = _rect_inputs(dev, lq * lk + e, b, lq, lk, e)
    want = K5.rect_attention_reference(heads, q, k, v, q_pad, k_pad)
    before = K5.fwd_launches, K5.bwd_launches
    with torch.no_grad():
        got = K5.rect_attention(heads, q, k, v, q_pad, k_pad)
    assert float((got - want).abs().max()) <= TOL
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (K5.fwd_launches, K5.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    assert float((out.detach() - want).abs().max()) <= TOL
    wgrads = K5.rect_attention_backward_reference(heads, q, k, v, q_pad,
                                                  k_pad, g)
    for i, (gk, gw) in enumerate(zip(grads, wgrads)):
        assert _rel_err(gk, gw) <= GRAD_REL_TOL, i


def test_rect_attention_kernel_refuses_bf16_and_other_head_dims(dev):
    """The kernels take q/k/v all f32 or all bf16 (``rect_attention``
    casts k and v to q's mode first; float16 is no mode) and head dims up
    to 256 (the others padded to the next tile)."""
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    q, k, v, q_pad, k_pad, _ = _rect_inputs(dev, 0, 2, 8, 16, 64, False)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        K5.rect_attention_forward(2, q.bfloat16(), k, v, q_pad, k_pad)
    with pytest.raises(ValueError, match="f32 or bf16"):
        K5.rect_attention(2, q.half(), k.half(), v.half(), q_pad, k_pad)
    wide = [torch.zeros(x.shape[0], x.shape[1], 512, device=dev)
            for x in (q, k, v)]
    with pytest.raises(ValueError, match="head dims"):
        K5.rect_attention(1, *wide, q_pad, k_pad)
    with pytest.raises(ValueError, match="head dims"):
        K5.rect_attention(1, *(x.bfloat16() for x in wide), q_pad, k_pad)


@pytest.mark.parametrize("b,lq,lk,e,heads", [
    (32, 252, 2016, 256, 4), (32, 252, 252, 256, 4), (2, 16, 128, 64, 2),
    (2, 128, 16, 64, 2), (3, 40, 40, 128, 2), (2, 10, 20, 64, 2),
    (2, 12, 96, 64, 2), (3, 63, 129, 128, 4),
])
def test_rect_attention_bf16_kernels_match_plain_bf16(dev, b, lq, lk, e,
                                                      heads):
    """K5/K6's bf16 mode (bf16 q, k, v; f32 context) vs the plain bf16
    version, fully masked rows included: the forward within 1e-2 (the
    normalized weights round to bf16 in both, and a weight on a rounding
    boundary may round the other way: 2^-8 of a weight up to 1 times a
    value up to ~5; 1.3e-3 at B32 x 252 x 252), dq, dk and dv bf16 within
    BF16_SHORT[2] of the largest; +2 / +1 bf16 launches and no f32 ones.
    Two calls of each kernel on the same inputs give the same bits, and
    the backward allocates no more than its outputs and
    ``bf16_backward_workspace_bytes`` (each allocation rounded to the
    caching allocator's 512 bytes). An f32 q with bf16 k and v runs the
    f32 mode on k and v converted, and rounds dk and dv to bf16."""
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    bf = torch.bfloat16
    q, k, v, q_pad, k_pad, g = _rect_inputs(dev, lq + lk + e, b, lq, lk, e)
    q, k, v = q.to(bf), k.to(bf), v.to(bf)
    want = K5.rect_attention_bf16_reference(heads, q, k, v, q_pad, k_pad)
    names = ("fwd_launches", "bwd_launches", "bf16_fwd_launches",
             "bf16_bwd_launches")
    before = [getattr(K5, n) for n in names]
    with torch.no_grad():
        got = K5.rect_attention(heads, q, k, v, q_pad, k_pad)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [getattr(K5, n) for n in names] == [*before[:2], before[2] + 2,
                                                before[3] + 1]
    assert got.dtype == out.dtype == torch.float32
    for o in (got, out):
        assert float((o.detach() - want).abs().max()) <= 1e-2
    wgrads = K5.rect_attention_backward_reference(heads, q, k, v, q_pad,
                                                  k_pad, g)
    largest = max(float(w.float().abs().max()) for w in wgrads)
    for i, (gk, gw) in enumerate(zip(grads, wgrads)):
        assert gk.dtype == gw.dtype == bf, i
        assert float((gk.float() - gw.float()).abs().max()) <= (
            BF16_SHORT[2] * largest), i
    # the same bits run to run; the backward's scratch
    args = (heads, q, k, v, q_pad, k_pad)
    first = K5.rect_attention_forward(*args, residuals=True)
    again = K5.rect_attention_forward(*args, residuals=True)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    back = K5.rect_attention_backward(*args, *first, g)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated(dev) - base - sum(
        x.numel() * x.element_size() for x in back)
    assert scratch <= K5.bf16_backward_workspace_bytes(
        heads, b, lq, lk, e) + 4 * 512
    again = K5.rect_attention_backward(*args, *first, g)
    assert all(torch.equal(x, y) for x, y in zip(back, again))
    # the later blocks' mix: f32 q, bf16 k and v
    q32 = q.float().requires_grad_()
    kv = [x.clone().requires_grad_() for x in (k, v)]
    before = [getattr(K5, n) for n in names]
    out = K5.rect_attention(heads, q32, *kv, q_pad, k_pad)
    grads = torch.autograd.grad(out, [q32, *kv], g)
    assert [getattr(K5, n) for n in names] == [before[0] + 1, before[1] + 1,
                                                *before[2:]]
    assert [x.dtype for x in grads] == [torch.float32, bf, bf]
    want = K5.rect_attention_reference(heads, q32.detach(), k.float(),
                                       v.float(), q_pad, k_pad)
    assert float((out.detach() - want).abs().max()) <= TOL


def _rect_holds_to_plain(dev, heads, q, k, v, q_pad, k_pad, g):
    """The forward (no grad, and with residuals under grad) <= TOL of the
    plain version, K6's gradients through it within GRAD_REL_TOL of the
    largest plain gradient of the three (at Lk 1 dq and dk are exactly
    zero), two forward launches and one backward."""
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    want = K5.rect_attention_reference(heads, q, k, v, q_pad, k_pad)
    before = K5.fwd_launches, K5.bwd_launches
    with torch.no_grad():
        got = K5.rect_attention(heads, q, k, v, q_pad, k_pad)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (K5.fwd_launches, K5.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    assert float((got - want).abs().max()) <= TOL
    assert float((out.detach() - want).abs().max()) <= TOL
    wgrads = K5.rect_attention_backward_reference(heads, q, k, v, q_pad,
                                                  k_pad, g)
    largest = max(float(w.abs().max()) for w in wgrads)
    for i, (gk, gw) in enumerate(zip(grads, wgrads)):
        assert float((gk - gw).abs().max()) <= GRAD_REL_TOL * largest, i
    return got


@pytest.mark.parametrize("lq,lk", [
    (1, 1), (1, 2016), (17, 63), (63, 17), (65, 129), (129, 65),
    (2016, 129), (129, 2016),
])
def test_rect_attention_kernels_at_ragged_tiles(dev, lq, lk):
    """Lq and Lk that are not multiples of the forward's 64-row q tile and
    64-key tile."""
    inputs = _rect_inputs(dev, 7 * lq + lk, 2, lq, lk, 128, full_row=False)
    _rect_holds_to_plain(dev, 2, *inputs)


def test_rect_attention_fully_masked_rows_beside_normal_rows(dev):
    """Rows 3, 9 and 40 of batch 0 are padding and every key they see is
    padding: each averages v over all Lk keys, while the other rows of
    their q tile (rows 0-63) take the masked softmax."""
    lq, lk = 100, 800
    q, k, v, q_pad, k_pad, g = _rect_inputs(dev, 11, 2, lq, lk, 256,
                                            full_row=False)
    q_pad[0] = False
    q_pad[0, [3, 9, 40]] = True
    k_pad[0] = False
    k_pad[0, :-(-41 * lk // lq)] = True
    got = _rect_holds_to_plain(dev, 4, q, k, v, q_pad, k_pad, g)
    mean = v[0].mean(dim=0)
    for i in (3, 9, 40):
        assert float((got[0, i] - mean).abs().max()) <= TOL
    assert float((got[0, 4] - mean).abs().max()) > 1e-2


@pytest.mark.parametrize("b,lq,lk,e,heads", [
    (32, 252, 2016, 256, 4), (3, 129, 65, 128, 2),
])
def test_rect_attention_backward_is_bit_identical_run_to_run(dev, b, lq, lk,
                                                              e, heads):
    """Two backward calls on the same inputs give the same bits (the dQ
    partials are summed in key-block order, no atomics), one launch
    counted each."""
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    q, k, v, q_pad, k_pad, g = _rect_inputs(dev, lq + lk, b, lq, lk, e)
    args = (heads, q, k, v, q_pad, k_pad)
    ctx, m, l = K5.rect_attention_forward(*args, residuals=True)
    before = K5.bwd_launches
    first = K5.rect_attention_backward(*args, ctx, m, l, g)
    second = K5.rect_attention_backward(*args, ctx, m, l, g)
    torch.cuda.synchronize()
    assert K5.bwd_launches == before + 2
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lk", [2016, 252])
def test_rect_attention_kernels_at_head_dim_32(dev, lk):
    inputs = _rect_inputs(dev, lk, 4, 252, lk, 128)
    _rect_holds_to_plain(dev, 4, *inputs)


def _flagship_rollout(dev, batch, dtype, mode="teacher", frames=6):
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.infer import generate as G
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    model = Metaformer(LSTMFORMER_MODEL_CFG,
                       generator=torch.Generator().manual_seed(0), device=dev)
    lead, ratio = 12, 8
    rng = np.random.default_rng(batch + frames)
    shapes = [(batch, frames * ratio, 81), (batch, frames, 18),
              (batch, frames, 18), (batch, lead * ratio, 81),
              (batch, lead, 18), (batch, lead, 18), (batch, frames, 18)]
    data = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in shapes]
    mask = G.sampling_mask_for(frames, mode, device=dev)
    with torch.no_grad():
        states, ea, em, ms, la, lm = G._hoist_and_warmup(model, data, dtype)
        return G._fused_rollout_args(model, states, ea, em, ms, mask, dtype,
                                     la, lm)


@pytest.mark.parametrize("batch", [1, 16, 17, 64])
def test_decode_rollout_kernel_at_batches(dev, batch):
    """f32 kernel vs f32 plain, teacher-forced, one launch per 16 dialogs;
    bf16 kernel vs the f32 plain version within the bf16 bound."""
    args, kw = _flagship_rollout(dev, batch, torch.float32)
    with torch.no_grad():
        before = K2.launches
        got = K2.decode_rollout(*args, **kw)
        torch.cuda.synchronize()
        assert K2.launches == before + (batch + 15) // 16
        want = K2.decode_rollout_reference(*args, **kw)
        assert float((got - want).abs().max()) <= TOL
        a16, kw16 = _flagship_rollout(dev, batch, torch.bfloat16)
        got16 = K2.decode_rollout(*a16, **kw16)
    assert float((got16 - want).abs().max()) <= 5e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, 5e-2)])
def test_decode_rollout_kernel_across_ring_wrap(dev, dtype, tol):
    """Rings of the flagship's 10 s context primed to within two steps of
    their end: the audio ring (1000 slots, 8 per step) and the motion
    ring (125) wrap during an 8-step rollout.
    The kernel (in ``dtype``) against the f32 plain version on the same
    numbers; the caller's rings stay as they were."""
    from multimodalreactiongeneration_tpu_torch.configs import (
        LSTMFORMER_MODEL_CFG,
    )
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    model = Metaformer(LSTMFORMER_MODEL_CFG,
                       generator=torch.Generator().manual_seed(1), device=dev)
    b, steps, ratio, h, sa, sm, nb = 16, 8, 8, 256, 1000, 125, 5
    r = _rand(np.random.default_rng(5), dev)
    f32 = dict(ca0=r(b, sa, h, s=0.5), cm0=r(b, sm, h, s=0.5),
               enc_a_steps=r(steps, b, ratio, h, s=0.5),
               enc_m_steps=r(steps, b, h, s=0.5))
    state = (r(nb, b, h, s=0.3), r(nb, b, h, s=0.3), r(b, h), )
    gt, mask = r(steps, b, h), torch.zeros(steps, device=dev)
    mask[::3] = 1.0  # every third step feeds back the model's sample
    kw = dict(heads=4, ratio=ratio, len_a0=sa - 2 * ratio, len_m0=sm - 2,
              bud_m=sm)

    def run(dt, fn):
        folded = K2.fold_decode_params(model, nb, 4, mm_dtype=dt)
        rings = {k: v.to(dt) for k, v in f32.items()}
        kept = {k: v.clone() for k, v in rings.items()}
        out = fn(folded, rings["ca0"], rings["cm0"], *state,
                 rings["enc_a_steps"], rings["enc_m_steps"], gt, mask, **kw)
        for k in rings:
            assert torch.equal(rings[k], kept[k]), k
        return out

    with torch.no_grad():
        want = run(torch.float32, K2.decode_rollout_reference)
        got = run(dtype, K2.decode_rollout)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("t", [16, 17, 2016])
def test_gru_kernels_match_plain(dev, t, h):
    """K10 forward without and with residuals, and backward, vs plain, at
    both hidden sizes the kernels take, batch 28 (a ragged 12-row second
    cluster), from the shortest kernel route (T 16) to the audio encoder
    in training (T 2016)."""
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    b = 28
    r = _rand(np.random.default_rng(b * t + h), dev)
    args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06), r(3 * h, s=0.1),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h))
    ysr, hr = K10.gru_recurrence_reference(*args)
    before = K10.fwd_launches, K10.bwd_launches
    ys, hn = K10.gru_recurrence(*args)  # no grad needed: no residuals
    for got, want in ((ys, ysr), (hn, hr)):
        assert float((got - want).abs().max()) <= TOL
    leaves = [a.clone().requires_grad_() for a in args]
    ys, hn = K10.gru_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn), leaves, cots)
    torch.cuda.synchronize()
    assert (K10.fwd_launches, K10.bwd_launches) == (before[0] + 2,
                                                    before[1] + 1)
    for got, want in ((ys, ysr), (hn, hr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    want = K10.gru_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("t", [1, 37, 252])
@pytest.mark.parametrize("b", [1, 17, 33])
def test_gru_kernels_are_bit_identical_run_to_run(dev, b, t, h):
    """Two K10 forwards (with residuals) and two backwards on the same
    inputs give the same bits (fixed summation orders, no atomics), with
    one launch counted per call; and they agree with the plain version
    (forward TOL, gradients GRAD_REL_TOL of the largest)."""
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    r = _rand(np.random.default_rng(1000 * b + t + h), dev)
    args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06), r(3 * h, s=0.1),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h))
    before = K10.fwd_launches, K10.bwd_launches
    first = K10.gru_forward(args, True)
    second = K10.gru_forward(args, True)
    assert K10.fwd_launches == before[0] + 2
    grads = [K10.gru_backward(args, first[0], first[2], *cots)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert K10.bwd_launches == before[1] + 2
    for x, y in zip((*first, *grads[0]), (*second, *grads[1])):
        assert torch.equal(x, y)
    ysr, hr = K10.gru_recurrence_reference(*args)
    for got, want in ((first[0], ysr), (first[1], hr)):
        assert float((got - want).abs().max()) <= TOL
    want = K10.gru_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads[0], want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


@pytest.mark.parametrize("b", [113, 129])
def test_gru_kernels_match_plain_past_one_wave_of_16_cta_clusters(dev, b):
    """At H 256 a batch whose clusters of 16 CTAs the card does not hold
    at once (an H100 holds 7: up to 112 rows) runs over clusters of 8
    CTAs (the yaml's own batch is 128): forward with residuals and
    backward vs plain, the same bits from run to run."""
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    h, t = 256, 37
    r = _rand(np.random.default_rng(b), dev)
    args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06), r(3 * h, s=0.1),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h))
    resident = K10._lib().gru_resident_clusters(h, 16)
    assert K10.launch_ctas(dev, b, h) == (16 if -(-b // 16) <= resident
                                          else 8)
    first = K10.gru_forward(args, True)
    grads = [K10.gru_backward(args, first[0], first[2], *cots)
             for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(grads[0], grads[1]):
        assert torch.equal(x, y)
    ysr, hr = K10.gru_recurrence_reference(*args)
    for got, want in ((first[0], ysr), (first[1], hr)):
        assert float((got - want).abs().max()) <= TOL
    want = K10.gru_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads[0], want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def test_gru_kernel_refuses_bf16_and_other_hidden_sizes(dev):
    from multimodalreactiongeneration_tpu_torch.nn.recurrent import (
        use_gru_kernel,
    )
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    b, t = 2, 16
    for h, dt, match in ((256, torch.bfloat16, "f32"),
                         (384, torch.float32, "hidden size 384"),
                         (512, torch.float32, "hidden size 512")):
        z = lambda *s: torch.zeros(*s, device=dev, dtype=dt)
        with pytest.raises(ValueError, match=match):
            K10.gru_recurrence(z(b, t, 3 * h), z(h, 3 * h), z(3 * h), z(b, h))
        with pytest.raises(ValueError, match=match):
            K10.gru_recurrence(z(b, t, 3 * h).requires_grad_(), z(h, 3 * h),
                               z(3 * h), z(b, h))
    for h in (384, 512):
        with pytest.raises(NotImplementedError, match="K10"):
            use_gru_kernel("cuda", 16, h)
    assert use_gru_kernel("cuda", 16, 128) and use_gru_kernel("cuda", 252, 256)
    assert use_gru_kernel("cuda", 16, 64) and use_gru_kernel("cuda", 16, 100)
    assert not use_gru_kernel("cuda", 15, 384)


@pytest.mark.parametrize("b,t,h", [
    (256, 120, 128), (32, 252, 256), (20, 37, 128), (1, 16, 128),
    (3, 1, 256),
])
def test_lstm_recurrence_kernels_match_plain(dev, b, t, h):
    """K8 forward without and with residuals, and backward, vs plain: a
    simple_lstm acoustic direction (B256 x T120 x H128), the flagship's
    self-motion LSTMs under MRGEN_FUSED_DW=0 (B32 x T252 x H256), and
    ragged shapes (B and T not multiples of 16, B1, T1)."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    r = _rand(np.random.default_rng(b * t + h), dev)
    args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06), r(b, h, s=0.3),
            r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    ysr, (hr, cr) = K8.lstm_recurrence_reference(*args)
    before = K8.fwd_launches, K8.bwd_launches
    ys, (hn, cn) = K8.lstm_recurrence(*args)  # no grad needed: no residuals
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got - want).abs().max()) <= TOL
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K8.lstm_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K8.fwd_launches, K8.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
    for got, want in ((ys, ysr), (hn, hr), (cn, cr)):
        assert float((got.detach() - want).abs().max()) <= TOL
    want = K8.lstm_recurrence_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


def test_lstm_recurrence_kernel_refuses_bf16_and_other_hidden_sizes(
        dev, monkeypatch):
    """Every refusal of the wrappers names K8: other dtypes and hidden
    sizes. A cluster size the kernels do not take at that hidden size,
    forced past the wrapper's choice, is refused by the C entry point
    before anything is launched or counted."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    b, t = 2, 16
    for h, dt, match in ((128, torch.bfloat16, "f32"),
                         (320, torch.float32, "hidden size 320"),
                         (384, torch.float32, "hidden size 384")):
        z = lambda *s: torch.zeros(*s, device=dev, dtype=dt)
        for grad in (False, True):
            xw = z(b, t, 4 * h).requires_grad_(grad)
            with pytest.raises(ValueError, match=match) as info:
                K8.lstm_recurrence(xw, z(h, 4 * h), z(b, h), z(b, h))
            assert "K8" in str(info.value)
    z = lambda *s: torch.zeros(*s, device=dev)
    before = K8.fwd_launches
    for h, ctas in ((128, 16), (128, 2), (256, 4)):
        monkeypatch.setattr(K8, "launch_ctas", lambda d, b, h, *mode: ctas)
        with pytest.raises(RuntimeError, match="lstm_recurrence_forward_f32"):
            K8.lstm_recurrence_forward(
                (z(b, t, 4 * h), z(h, 4 * h), z(b, h), z(b, h)), False)
    assert K8.fwd_launches == before


# K10's and K8's bf16 modes (bf16 W_hh, the rest f32) vs their plain bf16
# versions, at the bounds of the K7/K9 bf16 modes above (_bf16_within):
# the short bounds to T 40, past it the JAX bf16 bound; the kernel's ys
# within a quarter of the plain f32 version's distance from the plain
# bf16 ys, past T 40 over the first 16 steps (a flip compounds along the
# chain: a one-ulp input move takes the plain bf16 version itself 0.28 to
# 0.34 of that distance over 252 steps, tools/bf16_chaos_probe.py); dW_hh
# bf16, the other gradients f32; +2 / +1 bf16 launches and no f32 ones;
# two calls on the same inputs give the same bits.
RECURRENCE_MODE_STEPS = 16
@pytest.mark.parametrize("b,t,h", [
    (32, 16, 256), (32, 252, 256), (128, 252, 256), (17, 37, 128),
    (3, 1, 256),
])
def test_gru_bf16_kernels_match_plain_bf16(dev, b, t, h):
    """K10's bf16 mode at the GRU Metaformer's shapes (B32 x T252; the
    yaml's B128, on the clusters the bf16 residency picks) and ragged
    ones."""
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10

    r = _rand(np.random.default_rng(b * t + h + 1), dev)
    args = (r(b, t, 3 * h, s=0.5), r(h, 3 * h, s=0.06).to(torch.bfloat16),
            r(3 * h, s=0.1), r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h))
    before = (K10.fwd_launches, K10.bwd_launches, K10.bf16_fwd_launches,
              K10.bf16_bwd_launches)
    ys0, hn0 = K10.gru_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, hn = K10.gru_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn), leaves, cots)
    torch.cuda.synchronize()
    assert (K10.fwd_launches, K10.bwd_launches, K10.bf16_fwd_launches,
            K10.bf16_bwd_launches) == (*before[:2], before[2] + 2,
                                       before[3] + 1)
    assert [g.dtype for g in grads] == [torch.float32, torch.bfloat16,
                                        torch.float32, torch.float32]
    ysr, hr = K10.gru_recurrence_reference(*args)
    ys32, _ = K10.gru_recurrence_reference(*[a.float() for a in args])
    _bf16_within((ys0, hn0, ys, hn), grads, (ysr, hr) * 2,
                 K10.gru_backward_reference(args, *cots), short=t <= 40,
                 ys_f32=ys32 if t > 1 else None,
                 mode_steps=None if t <= 40 else RECURRENCE_MODE_STEPS)
    first = K10.gru_forward(args, True)
    again = K10.gru_forward(args, True)
    g1, g2 = (K10.gru_backward(args, first[0], first[2], *cots)
              for _ in range(2))
    for x, y in zip((*first[:2], first[2], *g1), (*again[:2], again[2], *g2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,t,h", [
    (256, 120, 128), (32, 252, 256), (20, 37, 128), (1, 16, 128),
    (3, 1, 256),
])
def test_lstm_recurrence_bf16_kernels_match_plain_bf16(dev, b, t, h):
    """K8's bf16 mode at the MRGEN_FUSED_DW=0 shapes (lws's blocks at
    B256, the flagship's self-motion LSTMs at B32 x T252) and ragged
    ones."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    r = _rand(np.random.default_rng(b * t + h + 2), dev)
    args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06).to(torch.bfloat16),
            r(b, h, s=0.3), r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    before = (K8.fwd_launches, K8.bwd_launches, K8.bf16_fwd_launches,
              K8.bf16_bwd_launches)
    ys0, (hn0, cn0) = K8.lstm_recurrence(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K8.lstm_recurrence(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert (K8.fwd_launches, K8.bwd_launches, K8.bf16_fwd_launches,
            K8.bf16_bwd_launches) == (*before[:2], before[2] + 2,
                                      before[3] + 1)
    assert [g.dtype for g in grads] == [torch.float32, torch.bfloat16,
                                        torch.float32, torch.float32]
    ysr, (hr, cr) = K8.lstm_recurrence_reference(*args)
    ys32, _ = K8.lstm_recurrence_reference(*[a.float() for a in args])
    _bf16_within((ys0, hn0, cn0, ys, hn, cn), grads, (ysr, hr, cr) * 2,
                 K8.lstm_recurrence_backward_reference(args, *cots),
                 short=t <= 40, ys_f32=ys32 if t > 1 else None,
                 mode_steps=None if t <= 40 else RECURRENCE_MODE_STEPS)
    first = K8.lstm_recurrence_forward(args, True)
    again = K8.lstm_recurrence_forward(args, True)
    g1, g2 = (K8.lstm_recurrence_backward(args, first[0], first[3],
                                          first[4], *cots) for _ in range(2))
    for x, y in zip((*first, *g1), (*again, *g2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kernel", ["gru", "lstm_recurrence"])
def test_bf16_recurrences_pick_clusters_from_their_own_residency(dev,
                                                                 kernel):
    """The bf16 mode's cluster size comes from the occupancy of its own
    instantiation (fewer registers than the FP32 mode's hi/lo fragments),
    at every hidden size and around each size's one-wave limit."""
    from multimodalreactiongeneration_tpu_torch.ops import cluster_size
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    mod = K10 if kernel == "gru" else K8
    query = getattr(mod._lib(), f"{kernel}_resident_clusters_bf16")
    for h, sizes in mod.CLUSTER_CTAS.items():
        resident = {c: query(h, c) for c in sizes}
        assert all(n > 0 for n in resident.values()), (h, resident)
        for b in (1, 16 * resident[sizes[0]], 16 * resident[sizes[0]] + 1):
            assert mod.launch_ctas(dev, b, h, True) == \
                cluster_size.cluster_ctas(b, sizes, resident.get)


def _k8_case(dev, seed, b, t, h):
    r = _rand(np.random.default_rng(seed), dev)
    args = (r(b, t, 4 * h, s=0.5), r(h, 4 * h, s=0.06), r(b, h, s=0.3),
            r(b, h, s=0.3))
    return args, (r(b, t, h), r(b, h), r(b, h))


def _k8_runs_twice_and_holds_to_plain(K8, args, cots):
    """Two K8 forwards without residuals, two with, two backwards: the
    same bits each time, one launch counted per call; then forward TOL
    and gradients GRAD_REL_TOL of the largest against plain."""
    before = K8.fwd_launches, K8.bwd_launches
    bare = [K8.lstm_recurrence_forward(args, False)[:3] for _ in range(2)]
    first, second = [K8.lstm_recurrence_forward(args, True)
                     for _ in range(2)]
    grads = [K8.lstm_recurrence_backward(args, first[0], first[3], first[4],
                                         *cots)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert (K8.fwd_launches, K8.bwd_launches) == (before[0] + 4,
                                                  before[1] + 2)
    for x, y in zip((*bare[0], *first, *grads[0]),
                    (*bare[1], *second, *grads[1])):
        assert torch.equal(x, y)
    for x, y in zip(bare[0], first[:3]):  # residuals change no output
        assert torch.equal(x, y)
    ysr, (hr, cr) = K8.lstm_recurrence_reference(*args)
    for got, want in zip(first[:3], (ysr, hr, cr)):
        assert float((got - want).abs().max()) <= TOL
    want = K8.lstm_recurrence_backward_reference(args, *cots)
    for i, (g, w) in enumerate(zip(grads[0], want)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("t", [1, 37, 252])
@pytest.mark.parametrize("b", [1, 17, 33])
def test_lstm_recurrence_kernels_are_bit_identical_run_to_run(dev, b, t, h):
    """K8 at the cluster size the wrapper chooses: two calls of each
    kernel on the same inputs give the same bits (fixed summation orders,
    no atomics), and agree with the plain version."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    args, cots = _k8_case(dev, 1000 * b + t + h, b, t, h)
    _k8_runs_twice_and_holds_to_plain(K8, args, cots)


@pytest.mark.parametrize("h", [128, 256])
@pytest.mark.parametrize("b", [1, 17, 113, 256])
def test_lstm_recurrence_kernels_at_every_cluster_size(dev, b, h,
                                                       monkeypatch):
    """K8 at B 1 to 256 with every cluster size the kernels take at this
    H forced once (at H 256 and B 113 or more the 16-CTA clusters run in
    waves), and at the wrapper's choice: the same bits run to run, within
    the gates of plain; the choice is the faster size while every cluster
    of the batch fits on the card at once."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
    from multimodalreactiongeneration_tpu_torch.ops.cluster_size import (
        cluster_ctas,
    )

    args, cots = _k8_case(dev, 7 * b + h, b, 37, h)
    resident = {c: K8._lib().lstm_recurrence_resident_clusters(h, c)
                for c in K8.CLUSTER_CTAS[h]}
    assert all(n > 0 for n in resident.values()), resident
    assert K8.launch_ctas(dev, b, h) == cluster_ctas(b, K8.CLUSTER_CTAS[h],
                                                     resident.get)
    for ctas in K8.CLUSTER_CTAS[h]:
        monkeypatch.setattr(K8, "launch_ctas", lambda d, b, h, *mode: ctas)
        _k8_runs_twice_and_holds_to_plain(K8, args, cots)


@pytest.mark.parametrize("din", [256, 81])
def test_lstm_layer_and_recurrence_on_flipped_input(dev, din):
    """The reverse direction of a bidirectional LSTM: K7 (din 256) or K8
    (din 81) on the time-flipped input, flipped back, vs the plain
    recurrence run backwards in time, forward and gradients."""
    from multimodalreactiongeneration_tpu_torch.nn.recurrent import TorchLSTM
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8

    b, t, h = 24, 120, 128
    lstm = TorchLSTM(din, h, torch.Generator().manual_seed(din),
                     bidirectional=True).to(dev)
    x = _rand(np.random.default_rng(din), dev)(b, t, din).requires_grad_()
    before = (K7.fwd_launches, K7.bwd_launches, K8.fwd_launches,
              K8.bwd_launches)
    ys, (hn, cn) = lstm(x)
    g = torch.randn_like(ys)
    grads = torch.autograd.grad((ys * g).sum() + hn.sum(),
                                [x, *lstm.parameters()])
    torch.cuda.synchronize()
    k7 = din % 128 == 0
    assert (K7.fwd_launches, K7.bwd_launches, K8.fwd_launches,
            K8.bwd_launches) == (before[0] + 2 * k7, before[1] + 2 * k7,
                                 before[2] + 2 * (not k7),
                                 before[3] + 2 * (not k7))
    leaves = [x.detach().clone().requires_grad_(), *[
        p.detach().clone().requires_grad_() for p in lstm.parameters()]]
    z = torch.zeros(b, h, device=dev)

    def plain(x, *params):
        outs, hs = [], []
        for d in range(2):
            w_ih, w_hh, b_ih, b_hh = params[4 * d:4 * d + 4]
            xd = torch.flip(x, [1]) if d else x
            y, (hd, _) = K7.lstm_layer_reference(xd, w_ih.T, b_ih + b_hh,
                                                 w_hh.T, z, z)
            outs.append(torch.flip(y, [1]) if d else y)
            hs.append(hd)
        return torch.cat(outs, -1), torch.stack(hs)

    ysr, hr = plain(*leaves)
    want = torch.autograd.grad((ysr * g).sum() + hr.sum(), leaves)
    assert float((ys.detach() - ysr.detach()).abs().max()) <= TOL
    assert float((hn.detach() - hr.detach()).abs().max()) <= TOL
    for i, (gk, gw) in enumerate(zip(grads, want)):
        assert _rel_err(gk, gw) <= GRAD_REL_TOL, i


# Every head dim and hidden size up to 256: the kernels are built for
# head dims 16 to 256 (powers of two) and hidden sizes 64, 128, 192 and
# 256; the wrappers run any other up to 256 padded with zeros to the
# next of them (exact), counted as one launch each way.
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,lq,lk,e,heads", [
    (32, 252, 2016, 256, 16), (32, 252, 2016, 192, 4),
    (32, 252, 2016, 256, 2), (32, 252, 2016, 256, 1), (3, 40, 96, 96, 4),
    (2, 12, 40, 8, 1), (3, 63, 129, 200, 1),
])
def test_rect_attention_kernels_at_every_head_dim(dev, b, lq, lk, e, heads,
                                                  bf16):
    """K5/K6 at head dims 16, 48 (on the 64 tile), 128, 256, 24, 8 and
    200 (on the 256 tile), f32 and bf16 operands, vs the plain version of
    the mode at the real head dim: f32 within TOL and GRAD_REL_TOL, bf16
    within 1e-2 and BF16_SHORT[2] (as
    ``test_rect_attention_bf16_kernels_match_plain_bf16``); +2 / +1
    launches of the mode's counters."""
    from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5

    q, k, v, q_pad, k_pad, g = _rect_inputs(dev, lq + lk + e + heads, b, lq,
                                            lk, e)
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    plain = (K5.rect_attention_bf16_reference if bf16
             else K5.rect_attention_reference)
    want = plain(heads, q, k, v, q_pad, k_pad)
    names = (("bf16_fwd_launches", "bf16_bwd_launches") if bf16
             else ("fwd_launches", "bwd_launches"))
    before = [getattr(K5, n) for n in names]
    with torch.no_grad():
        got = K5.rect_attention(heads, q, k, v, q_pad, k_pad)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = K5.rect_attention(heads, *leaves, q_pad, k_pad)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [getattr(K5, n) for n in names] == [before[0] + 2, before[1] + 1]
    assert got.shape == out.shape == (b, lq, e)
    for o in (got, out):
        assert float((o.detach() - want).abs().max()) <= (
            1e-2 if bf16 else TOL)
    wgrads = K5.rect_attention_backward_reference(heads, q, k, v, q_pad,
                                                  k_pad, g)
    largest = max(float(w.float().abs().max()) for w in wgrads)
    for i, (gk, gw) in enumerate(zip(grads, wgrads)):
        assert gk.dtype == gw.dtype == dt, i
        if bf16:
            assert float((gk.float() - gw.float()).abs().max()) <= (
                BF16_SHORT[2] * largest), i
        else:
            assert _rel_err(gk, gw) <= GRAD_REL_TOL, i


def _recurrence_case(kind, r, b, t, h, bf16):
    """(module, entry point, plain version, plain backward, args, cots,
    launch counter names) of K10 ("gru"), K8 ("lstm") or K9 ("stacked", 2
    layers: its layer route, or at H 65 to 128 the wavefront on H 128)."""
    from multimodalreactiongeneration_tpu_torch.ops import gru as K10
    from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
    from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9

    w = (lambda a: a.to(torch.bfloat16)) if bf16 else (lambda a: a)
    mode = "bf16_" if bf16 else ""
    if kind == "gru":
        args = (r(b, t, 3 * h, s=0.5), w(r(h, 3 * h, s=0.06)),
                r(3 * h, s=0.1), r(b, h, s=0.3))
        return (K10, K10.gru_recurrence, K10.gru_recurrence_reference,
                K10.gru_backward_reference, args, (r(b, t, h), r(b, h)),
                (f"{mode}fwd_launches", f"{mode}bwd_launches"))
    if kind == "lstm":
        args = (r(b, t, 4 * h, s=0.5), w(r(h, 4 * h, s=0.06)),
                r(b, h, s=0.3), r(b, h, s=0.3))
        return (K8, K8.lstm_recurrence, K8.lstm_recurrence_reference,
                K8.lstm_recurrence_backward_reference, args,
                (r(b, t, h), r(b, h), r(b, h)),
                (f"{mode}fwd_launches", f"{mode}bwd_launches"))
    args, cots = _stacked_args(r, b, t, h, 2, bf16)
    route = "" if K9.route(2, h) == "wavefront" else "layers_"
    return (K9, K9.lstm_stacked_recurrence, K9.lstm_stacked_reference,
            K9.lstm_stacked_backward_reference, args, cots,
            (f"{route}{mode}fwd_launches", f"{route}{mode}bwd_launches"))


def _flat_out(out):
    ys, state = out
    return (ys, *state) if isinstance(state, tuple) else (ys, state)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", ["gru", "lstm", "stacked"])
@pytest.mark.parametrize("b,t,h", [
    (32, 252, 64), (32, 252, 192), (32, 252, 100), (20, 37, 48),
    (17, 40, 160), (3, 16, 250),
])
def test_recurrence_kernels_at_every_hidden_size(dev, b, t, h, kind, bf16):
    """K10, K8 and K9 (2 layers: the layer route, and at H 100 the
    wavefront) at hidden sizes 64 and 192 (built) and 100, 48, 160 and
    250 (padded to 128, 64, 192 and 256), f32
    and bf16 W: the forward without and with residuals and the backward
    through the entry point vs the plain version at the real H (f32:
    TOL and GRAD_REL_TOL; bf16: ``_bf16_within`` as the bf16 tests of
    each kernel: the short bounds to T 40, the JAX bf16 bound past it,
    the distance test over the first ``RECURRENCE_MODE_STEPS`` steps); +2
    / +1 launches of the mode's counters."""
    r = _rand(np.random.default_rng(b * t + h + bf16), dev)
    mod, entry, plain, plain_bwd, args, cots, names = _recurrence_case(
        kind, r, b, t, h, bf16)
    before = [getattr(mod, n) for n in names]
    out0 = _flat_out(entry(*args))
    leaves = [a.clone().requires_grad_() for a in args]
    out = _flat_out(entry(*leaves))
    grads = torch.autograd.grad(out, leaves, cots)
    torch.cuda.synchronize()
    assert [getattr(mod, n) for n in names] == [before[0] + 2, before[1] + 1]
    want = _flat_out(plain(*args))
    want_grads = plain_bwd(args, *cots)
    if bf16:
        ys32 = _flat_out(plain(*[a.float() for a in args]))[0]
        _bf16_within(out0 + out, grads, want * 2, want_grads, short=t <= 40,
                     ys_f32=ys32,
                     mode_steps=None if t <= 40 else RECURRENCE_MODE_STEPS)
        return
    for got, w in zip(out0 + out, want * 2):
        assert float((got.detach() - w).abs().max()) <= TOL
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert _rel_err(g, w) <= GRAD_REL_TOL, i


# ---- the encoder stack at every hidden size to 512, K7 at 384 and 512 ----

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t,h,layers", [
    (3, 16, 8, 2), (19, 37, 100, 2), (16, 40, 192, 3), (5, 17, 300, 2),
    (19, 37, 384, 2), (17, 33, 448, 2), (19, 37, 512, 2), (32, 96, 512, 5),
])
def test_mixer_stack_every_hidden_kernels_match_plain(dev, b, t, h, layers,
                                                      bf16):
    """K3/K4 (and K1 without a gradient) at hidden sizes other than 128
    and 256: built widths (multiples of 8 from 128 to 256 on 8-CTA
    clusters, of 16 to 512 on 16-CTA ones; FP32 past 400 with part of W_hh
    read from L2) and padded ones (8 and 100 on 128, 300 on 304), against
    the plain version at the real width: f32 forward within TOL and
    gradients within GRAD_REL_TOL, the bf16 mode within ``_bf16_within``'s
    bounds (short to T16); +1 / +1 training launches of the mode, +1
    inference launch whose outputs are the training forward's bits."""
    r = _rand(np.random.default_rng(b * t + h + layers), dev)
    args = (_bf16_stack_args if bf16 else _stack_args)(r, b, t, h, layers)
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    pre = "bf16_" if bf16 else ""
    names = (f"{pre}train_fwd_launches", f"{pre}bwd_launches",
             f"{pre}launches")
    before = [getattr(K1, n) for n in names]
    leaves = [a.clone().requires_grad_() for a in args]
    y, (hn, cn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad((y, hn, cn), leaves, cots)
    with torch.no_grad():
        yi, (hi, ci) = K1.mixer_stack_recurrence(*args)
    torch.cuda.synchronize()
    assert [getattr(K1, n) for n in names] == [v + 1 for v in before]
    for got, want in ((yi, y), (hi, hn), (ci, cn)):
        assert torch.equal(got, want.detach())
    yr, (hr, cr) = K1.mixer_stack_forward_reference(*args)
    want = K1.mixer_stack_backward_reference(args, *cots)
    if bf16:
        # past H 256 the distance test reads the first 4 steps within
        # WIDE_MODE_FRAC: there two faithful plain bf16 stacks, one summing
        # in f64, part by 0.011-0.18 of the f32 distance, but by 0.17-0.22
        # and 0.83 over these lengths
        y32 = K1.mixer_stack_forward_reference(*[a.float() for a in args])[0]
        _bf16_within((y, hn, cn), grads, (yr, hr, cr), want, short=t <= 16,
                     ys_f32=y32,
                     mode_steps=None if h <= 256 and layers <= 3 and t <= 40
                     else 4,
                     mode_frac=WIDE_MODE_FRAC if h > 256 else 0.25)
    else:
        _assert_within_gates((y, hn, cn, *grads), (yr, hr, cr, *want), 3)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t,h,layers,chunk", [
    (17, 37, 384, 2, 8), (33, 101, 512, 5, 16), (19, 37, 200, 3, 5)])
def test_mixer_stack_wide_chunks_bitwise_equal_layer_major(dev, b, t, h,
                                                           layers, chunk,
                                                           bf16):
    """At the new widths any chunk gives chunk=T's bits: the training
    forward (every residual plane) and dx0, dh0, dc0; two backward runs at
    one chunk the same bits."""
    r = _rand(np.random.default_rng(3 * b + t + h + chunk), dev)
    args = (_bf16_stack_args if bf16 else _stack_args)(r, b, t, h, layers)
    cots = (r(b, t, h), r(layers, b, h), r(layers, b, h))
    got_tr = K1.mixer_stack_train_forward(*args, chunk=chunk)
    want_tr = K1.mixer_stack_train_forward(*args, chunk=t)
    for g, w in zip(got_tr, want_tr):
        assert torch.equal(g, w)
    res = got_tr[3]
    got = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    again = K1.mixer_stack_backward(args, res, *cots, chunk=chunk)
    whole = K1.mixer_stack_backward(args, res, *cots, chunk=t)
    torch.cuda.synchronize()
    for i in (0, 10, 11):  # dx0, dh0, dc0
        assert torch.equal(got[i], whole[i]), i
    for i, (g, w) in enumerate(zip(got, again)):
        assert torch.equal(g, w), i


# the bf16 stack's distance test past H 256 (chip_smoke.BF16_WIDE_MODE_FRAC):
# the kernels read 0.21 and 0.32 of the f32 distance over the first 4 steps
# at B32 x L5 x T252 x H 384 and 512, the f32 kernel about 1
WIDE_MODE_FRAC = 0.5


@pytest.mark.parametrize("b,t,h,layers", [(19, 37, 384, 2),
                                          (32, 96, 512, 5)])
def test_mixer_stack_wide_bf16_distance_test_tells_the_modes_apart(
        dev, b, t, h, layers):
    """The control of the distance test past H 256: over the first 4
    steps the f32 kernel on the bf16 mode's values (f32 operands) reads
    past WIDE_MODE_FRAC of the f32 distance, the bf16 mode within it."""
    r = _rand(np.random.default_rng(b * t + h + layers), dev)
    args = _bf16_stack_args(r, b, t, h, layers)
    f32 = [a.float() for a in args]
    with torch.no_grad():
        want = K1.mixer_stack_forward_reference(*args)[0]
        y32 = K1.mixer_stack_forward_reference(*f32)[0]
        y16 = K1.mixer_stack_recurrence(*args)[0]
        y32k = K1.mixer_stack_recurrence(*f32)[0]
    assert _mode_distance(y16, want, y32, 4) <= WIDE_MODE_FRAC
    assert _mode_distance(y32k, want, y32, 4) > WIDE_MODE_FRAC


def test_mixer_stack_wide_layout(dev):
    """16-CTA clusters past H 256, the wrapper's padding rule the
    kernels' cluster size at every H (and K7's at its four); an FP32 chain
    CTA keeps all of its W_hh slice to H 400 and part of it past (W_hh's
    rest in L2), a bf16 one all of it to 512; the card holds the 16-CTA
    clusters at once."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    for h in (8, 104, 256):
        assert K1.cluster_ctas(h) == 8
    for h in (272, 384, 512):
        assert K1.cluster_ctas(h) == 16
        assert K1.resident_clusters(h) >= 1
    for h in range(1, K1.MAX_H + 1):
        assert K1.launch_ctas(K1.stack_hidden(h)) == K1.cluster_ctas(h), h
    assert K1.launch_ctas(K1.MAX_H + 16) == -1
    assert [K7.launch_ctas(h) for h in (128, 256, 384, 512)] == [8, 8, 16, 16]
    assert (K1.kept(384, False), K1.kept(384, True)) == (384, 96)
    for backward, full in ((False, 512), (True, 128)):
        assert 0 < K1.kept(512, backward) < full
        assert K1.kept(512, backward, bf16=True) == full


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,t,h", [(16, 40, 384), (5, 17, 512),
                                   (32, 252, 512), (250, 17, 384)])
def test_lstm_layer_wide_kernels_match_plain(dev, b, t, h, bf16):
    """K7 at H 384 and 512 (16-CTA clusters; FP32 at 512 reads part of
    W_hh from L2 each step) at the rows the wrapper chooses and at R 16,
    against the plain version: f32 within TOL / GRAD_REL_TOL, bf16 within
    ``_bf16_within``'s bounds; +2 / +1 launches of the mode."""
    from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7

    r = _rand(np.random.default_rng(b * t + h), dev)
    wt = torch.bfloat16 if bf16 else torch.float32
    args = (r(b, t, h).to(wt), r(h, 4 * h, s=0.06).to(wt), r(4 * h, s=0.06),
            r(h, 4 * h, s=0.06).to(wt), r(b, h, s=0.3), r(b, h, s=0.3))
    cots = (r(b, t, h), r(b, h), r(b, h))
    pre = "bf16_" if bf16 else ""
    names = (f"{pre}fwd_launches", f"{pre}bwd_launches")
    before = [getattr(K7, n) for n in names]
    ys0, (hn0, cn0) = K7.lstm_layer(*args)
    leaves = [a.clone().requires_grad_() for a in args]
    ys, (hn, cn) = K7.lstm_layer(*leaves)
    grads = torch.autograd.grad((ys, hn, cn), leaves, cots)
    torch.cuda.synchronize()
    assert [getattr(K7, n) for n in names] == [before[0] + 2, before[1] + 1]
    ys16, hn16, cn16, acts, cs = K7.lstm_layer_forward(args, True, rows=16)
    grads16 = K7.lstm_layer_backward(args, ys16, acts, cs, *cots, rows=16)
    ysr, (hr, cr) = K7.lstm_layer_reference(*args)
    want = K7.lstm_layer_backward_reference(args, *cots)
    for outs, g in (((ys0, hn0, cn0, ys, hn, cn), grads),
                    ((ys16, hn16, cn16), grads16)):
        wouts = (ysr, hr, cr) * (len(outs) // 3)
        if bf16:
            # the distance test over the first 16 steps, as K8's and K10's:
            # the plain bf16 version summing in f64 parts from itself by
            # 0.01-0.024 of the f32 distance there, 0.31 over T252 at 512
            ys32, _ = K7.lstm_layer_reference(*[a.float() for a in args])
            _bf16_within(outs, g, wouts, want, short=t <= 40, ys_f32=ys32,
                         mode_steps=16)
        else:
            _assert_within_gates((*outs, *g), (*wouts, *want), len(outs))
