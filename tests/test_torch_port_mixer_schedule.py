"""PyTorch port: the encoder stack's layer-lagged chunk schedule, on the CPU.

``csrc/mixer_stack.cu`` runs the stack forward as chunks of C steps per
layer, layer l's chunk c after layer l-1's, each reading and writing the
rows of a (B, C) window of the (B, T) planes and carrying (h, c) from one
chunk to the next. The kernel has no CPU mode, so this file emulates the
schedule's bookkeeping in plain torch (enqueue order and the event
waits, the carries in ping-pong slots, t0 offsets, the row mapping
(r // n) * T + t0 + r % n, ragged last chunks, the inference forward's
chunk buffers and the training forward's full planes) and holds it to
the plain ``mixer_stack_forward_reference`` (f32, atol 1e-6: the same
arithmetic on gathered rows) and to the JAX ``RecurrentMixerLayerd`` on
its scan path (atol 2e-5, as tests/test_torch_port_mixer_stack.py).
It also covers ``chunk_steps`` and the wrappers' ``chunk`` argument.
The kernel is held to ``chunk=T`` bit for bit on the card in
tests/test_torch_port_kernels.py.
"""

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu_torch.nn.basic import layer_norm
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack
from tests.test_torch_port_mixer_stack import (
    ATOL, _inputs, _jax_ref, _pair, _stacked,
)

torch.set_num_threads(1)
REF_ATOL = 1e-6


def window_rows(b, t, t0, n):
    """Plane rows of the (b, n) window at step t0 of a (b, t) plane, in
    task-row order: row r is (r // n) * t + t0 + r % n (RowMap)."""
    r = torch.arange(b * n)
    return (r // n) * t + t0 + r % n


def emulate_schedule(args, chunk, train):
    """The chunk schedule of ``stack_forward`` in plain torch. Returns
    (out, hn, cn, block_outputs): the block outputs (B, T, H) of every
    layer, which the training forward keeps as residual planes and the
    inference forward keeps for all but the top layer."""
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0 = args
    bsz, t, h = x0.shape
    nl = w_hh_t.shape[0]
    mm = torch.matmul  # the plain version's f32 products
    outs = [torch.full((bsz * t, h), float("nan")) for _ in range(nl)]
    # the training forward's residual planes (B*T rows each)
    rnn_planes = [torch.full((bsz * t, h), float("nan")) for _ in range(nl)]
    carry = [[None, None] for _ in range(nl)]
    hn, cn = torch.empty(nl, bsz, h), torch.empty(nl, bsz, h)
    done = set()
    chunks = -(-t // chunk)
    for c in range(chunks):  # enqueue order: chunk-major, layers inside
        t0 = c * chunk
        n = min(chunk, t - t0)
        last = t0 + n == t
        win = window_rows(bsz, t, t0, n)
        for l in range(nl):
            # the event wait on (l-1, c) and the stream order after (l, c-1)
            assert l == 0 or (l - 1, c) in done
            assert c == 0 or (l, c - 1) in done
            xin = x0.reshape(bsz * t, h) if l == 0 else outs[l - 1]
            x_rows = xin[win]
            assert not torch.isnan(x_rows).any()  # written by (l-1, c)
            # 1. the input GEMM into the (B, n, 4H) chunk buffer
            xw = (mm(x_rows, w_ih_t[l]) + b_g[l]).reshape(bsz, n, 4 * h)
            # 2. the window recurrence from the carried state
            hc, cc = (h0[l], c0[l]) if c == 0 else carry[l][(c - 1) % 2]
            if train:  # rows of the (B, T) plane at t0
                rnn, rnn_t, rnn_t0 = rnn_planes[l], t, t0
            else:      # a dense (B, n) chunk buffer
                rnn, rnn_t, rnn_t0 = torch.empty(bsz * n, h), n, 0
            for j in range(n):
                gates = xw[:, j] + mm(hc, w_hh_t[l])
                i, f, g, o = gates.chunk(4, dim=-1)
                cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
                hc = torch.sigmoid(o) * torch.tanh(cc)
                rnn[torch.arange(bsz) * rnn_t + rnn_t0 + j] = hc
            if last:
                hn[l], cn[l] = hc, cc
            else:
                carry[l][c % 2] = (hc, cc)
            # 3. the tail on the window's rows
            m = win if train else torch.arange(bsz * n)
            y = layer_norm(rnn[m] + x_rows, g1[l], b1[l])
            z = mm(y, w_ff[l]) + b_ff[l]
            outs[l][win] = layer_norm(z + y, g2[l], b2[l])
            done.add((l, c))
    assert len(done) == nl * chunks
    planes = [o.reshape(bsz, t, h) for o in outs]
    return planes[-1], hn, cn, planes


def _args(num_layerd, t, b=3, h=16, seed=0):
    rng = np.random.default_rng(seed + 100 * num_layerd + t)

    def r(*shape, s=1.0, mean=0.0):
        x = mean + s * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.float32))

    n = num_layerd
    return (r(b, t, h), r(n, h, 4 * h, s=0.3), r(n, 4 * h, s=0.1),
            r(n, h, 4 * h, s=0.3), r(n, h, h, s=0.3), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, h, s=0.1, mean=1.0), r(n, h, s=0.1),
            r(n, b, h, s=0.3), r(n, b, h, s=0.3))


# (layers, T, C): C dividing T and not, C = 1, C = T, a chunk longer than
# the rest of the sequence
REF_CASES = [(1, 16, 4), (1, 21, 8), (2, 21, 1), (2, 21, 21), (2, 32, 16),
             (3, 33, 8), (3, 33, 16), (3, 7, 3), (3, 20, 19)]


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
@pytest.mark.parametrize("layers,t,chunk", REF_CASES)
def test_schedule_matches_reference(layers, t, chunk, train):
    args = _args(layers, t)
    want = mixer_stack.mixer_stack_forward_reference(*args)
    out, hn, cn, _ = emulate_schedule(args, chunk, train)
    for got, w in zip((out, hn, cn), (want[0], *want[1])):
        assert float((got - w).abs().max()) <= REF_ATOL


@pytest.mark.parametrize("layers,t,chunk", [(2, 21, 8), (3, 33, 16)])
def test_schedule_block_outputs_match_reference(layers, t, chunk):
    """Every block's output plane of the training forward (the residual
    the backward reads as the next block's input) is the output of the
    first l + 1 blocks of the plain stack."""
    args = _args(layers, t, seed=5)
    _, _, _, planes = emulate_schedule(args, chunk, train=True)
    x0, *weights, h0, c0 = args
    for l, plane in enumerate(planes):
        sub = [w[:l + 1] for w in weights]
        want, _ = mixer_stack.mixer_stack_forward_reference(
            x0, *sub, h0[:l + 1], c0[:l + 1])
        assert float((plane - want).abs().max()) <= REF_ATOL


def test_window_rows_cover_the_plane_once():
    """The windows of all chunks, ragged last one included, cover every
    row of the (B, T) plane exactly once."""
    b, t, chunk = 3, 21, 8
    rows = torch.cat([window_rows(b, t, t0, min(chunk, t - t0))
                      for t0 in range(0, t, chunk)])
    assert sorted(rows.tolist()) == list(range(b * t))
    # chunk = T: the identity
    assert torch.equal(window_rows(b, t, 0, t), torch.arange(b * t))


@pytest.mark.parametrize("layers,t,chunk",
                         [(1, 21, 8), (2, 21, 1), (2, 16, 16), (3, 33, 8)])
def test_schedule_matches_jax_module(layers, t, chunk):
    """At H16 the emulated schedule, from given states, matches the JAX
    stack (num_layerd blocks of RecurrentMixerLayerd)."""
    x, h0, c0 = _inputs(layers, t, seed=3)
    jm, params, pm = _pair(layers, 16, x, seed=t + 7)
    want = _jax_ref(jm, params, x, h0, c0)
    args = (torch.from_numpy(x), *_stacked(pm), torch.from_numpy(h0),
            torch.from_numpy(c0))
    with torch.no_grad():
        out, hn, cn, _ = emulate_schedule(args, chunk, train=False)
    for got, w in zip((out, hn, cn), want):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("t", [1, 7, 37, 252, 2016])
@pytest.mark.parametrize("layers", [1, 5])
def test_chunk_steps_range(t, layers):
    c = mixer_stack.chunk_steps(16, t, 256, layers)
    assert 1 <= c <= t
    if layers == 1:
        assert c == t  # no lag to hide: one chunk


@pytest.mark.parametrize("b,t,want", [(16, 2096, 64), (16, 262, 32),
                                      (32, 2016, 64), (32, 252, 32),
                                      (64, 2096, 64)])
def test_chunk_steps_at_the_encoders(b, t, want):
    """The encoder shapes take the chunks measured fastest there."""
    assert mixer_stack.chunk_steps(b, t, 256, 5) == want


def test_chunk_steps_shortens_the_chain_at_the_encoders():
    """At the encoder shapes the schedule runs more than one chunk, and
    the chain (chunks + L - 1) * C is shorter than L * T."""
    for b, t in ((16, 2096), (16, 262), (32, 2016), (32, 252)):
        c = mixer_stack.chunk_steps(b, t, 256, 5)
        assert c < t
        assert (-(-t // c) + 4) * c < 5 * t


def test_chunk_steps_rejects_empty_shapes():
    with pytest.raises(ValueError):
        mixer_stack.chunk_steps(0, 16, 256, 5)
    with pytest.raises(ValueError):
        mixer_stack.chunk_steps(16, 16, 256, 0)


def test_chunk_argument():
    """The wrappers' chunk: None picks chunk_steps; 1 to T pass; others
    raise."""
    c = mixer_stack._chunk
    assert c("f", 16, 2096, 256, 5, None) == mixer_stack.chunk_steps(
        16, 2096, 256, 5)
    assert c("f", 16, 2096, 256, 5, 2096) == 2096
    assert c("f", 2, 37, 256, 2, 1) == 1
    for chunk in (0, 38, -1):
        with pytest.raises(ValueError):
            c("f", 2, 37, 256, 2, chunk)
