"""PyTorch port: the encoder stack's reverse chunk schedule, on the CPU.

``csrc/mixer_stack.cu stack_backward`` runs the stack backward as chunks
of C steps per layer, from the last chunk to the first, layer l's chunk c
after layer l+1's. The kernel has no CPU mode, so this file emulates the
schedule's bookkeeping in plain torch: the reverse enqueue order and the
event waits on (l+1, c) and (l, c+1); the tail backward on a window's
rows; the reverse recurrence from the (dh, dc) carried between chunks,
dh as its 8 unsummed cluster slots; the window's reads of c_{t0-1} and
h_{t0-1} (c0, h0 at step 0); dx0 as the hand-off between blocks; the
per-layer gradient accumulators in stream order. Every residual row is
filled with NaN once no later chunk reads it, and each row of dx0 once
the block below has read it, so a read out of turn shows in the result.

The emulation's row products add one term at a time (``rowdot``), so a
row's result does not depend on how many rows a product takes, as the
kernel's do not. It is held to the plain
``mixer_stack_backward_reference`` (dx0, dh0 and dc0, which are O(1), at
atol 1e-5; the nine parameter gradients at a relative tolerance of 1e-5
of the gradient's largest magnitude where that is above 1: they sum B*T
rows and reach ~50 at L5 x T16), to the JAX ``mixer_stack_recurrence`` gradients
with ``pl.pallas_call`` in interpret mode (atol 5e-4, as
tests/test_pallas_mixer_stack.py; the JAX kernel takes two blocks or
more), and dx0, dh0, dc0 are held bit-equal across C. The kernel is held
to ``chunk=T`` bit for bit on the card in tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.ops import pallas_mixer_stack
from multimodalreactiongeneration_tpu_torch.nn.basic import layer_norm
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack
from tests.test_torch_port_mixer_schedule import _args, window_rows
from tests.test_torch_port_mixer_stack import _pair, _stacked

torch.set_num_threads(1)
REF_ATOL = 1e-5  # dx0, dh0, dc0
REF_RTOL = 1e-5  # the parameter gradients, of their largest magnitude
STATES = (0, 10, 11)  # dx0, dh0, dc0 in mixer_stack_backward's result
JAX_ATOL = 5e-4  # tests/test_pallas_mixer_stack.py's gradient tolerance
CL = 8  # CTAs per cluster: the slots dh_carry is carried in
LN_EPS = 1e-5


@pytest.fixture
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def rowdot(a, w):
    """a (M, K) @ w (K, N), one k at a time: each row's result is the same
    whatever the rows beside it."""
    acc = a[:, :1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + a[:, k:k + 1] * w[k]
    return acc


def rowsum(x):
    """Sum over the last dim, one column at a time."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def ln_bwd(dout, v, g):
    """LayerNorm backward of LN(v) * g + beta (the kernel's formula, the
    statistics recomputed in the forward's fast-variance form): the
    cotangent of v and xhat."""
    h = v.shape[-1]
    mu = rowsum(v) / h
    rstd = torch.rsqrt(rowsum(v * v) / h - mu * mu + LN_EPS)
    xhat = (v - mu[:, None]) * rstd[:, None]
    dv = dout * g
    m1, m2 = rowsum(dv) / h, rowsum(dv * xhat) / h
    return rstd[:, None] * (dv - m1[:, None] - xhat * m2[:, None]), xhat


def forward_residuals(args):
    """Per block the (B*T)-row planes the training forward keeps: h
    trajectory, gate activations [i, f, g, o], cell states, y, z, and
    the block's output but for the top block."""
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0 = args
    bsz, t, h = x0.shape
    x = x0.reshape(bsz * t, h)
    blocks = []
    for l in range(w_hh_t.shape[0]):
        xw = (x @ w_ih_t[l] + b_g[l]).reshape(bsz, t, 4 * h)
        hc, cc = h0[l], c0[l]
        rnn, acts, cs = [], [], []
        for j in range(t):
            i, f, g, o = (xw[:, j] + hc @ w_hh_t[l]).chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            cc = f * cc + i * g
            hc = o * torch.tanh(cc)
            rnn.append(hc)
            acts.append(torch.cat([i, f, g, o], -1))
            cs.append(cc)

        def plane(steps):
            return torch.stack(steps, 1).reshape(bsz * t, -1).clone()

        r = dict(rnn=plane(rnn), acts=plane(acts), cs=plane(cs))
        r["y"] = layer_norm(r["rnn"] + x, g1[l], b1[l])
        r["z"] = r["y"] @ w_ff[l] + b_ff[l]
        x = layer_norm(r["z"] + r["y"], g2[l], b2[l])
        r["out"] = x.clone()
        blocks.append(r)
    del blocks[-1]["out"]  # the top block's output is the stack's
    return blocks


def cell_slots(dgates, w_hh_t, h):
    """The partial dh_carry of each of the cluster's 8 CTAs: CTA s owns
    the gate columns g*H + s*U + u (U = H/8), in the order g, u."""
    u = h // CL
    slots = []
    for s in range(CL):
        cols = [g * h + s * u + k for g in range(4) for k in range(u)]
        slots.append(rowdot(dgates[:, cols], w_hh_t[:, cols].T))
    return slots


def emulate_backward(args, blocks, dout, dhn, dcn, chunk):
    """The reverse chunk schedule of ``stack_backward`` in plain torch.
    Returns the twelve input gradients, in argument order. ``blocks``
    (forward_residuals) is consumed: rows no later chunk reads are NaN
    afterwards."""
    x0, w_ih_t, b_g, w_hh_t, w_ff, b_ff, g1, b1, g2, b2, h0, c0 = args
    bsz, t, h = x0.shape
    nl = w_hh_t.shape[0]
    x0_rows = x0.reshape(bsz * t, h).clone()
    dout_rows = dout.reshape(bsz * t, h)
    dx0 = torch.full((bsz * t, h), float("nan"))
    dh0, dc0 = torch.empty(nl, bsz, h), torch.empty(nl, bsz, h)
    grads = {}  # per-layer accumulators, added in side-stream order
    carry = [[None, None] for _ in range(nl)]
    done, side_done = set(), set()
    chunks = -(-t // chunk)
    brow = torch.arange(bsz) * t

    def accumulate(name, l, part):
        key = (name, l)
        grads[key] = part if key not in grads else grads[key] + part

    for c in reversed(range(chunks)):  # enqueue order: the last chunk first
        t0 = c * chunk
        n = min(chunk, t - t0)
        first = c == chunks - 1
        win = window_rows(bsz, t, t0, n)
        for l in reversed(range(nl)):
            # the event waits on (l+1, c) and on the side stream's chunk
            # c+2 (the last user of the chunk buffers' slot c % 2), and the
            # stream order after (l, c+1)
            assert l == nl - 1 or (l + 1, c) in done
            assert c + 2 >= chunks or (l, c + 2) in side_done
            assert first or (l, c + 1) in done
            r = blocks[l]
            xin = x0_rows if l == 0 else blocks[l - 1]["out"]
            x_rows = xin[win]
            # 1. the tail backward on the window's rows
            dcur = dout_rows[win] if l == nl - 1 else dx0[win].clone()
            dx0[win] = float("nan")  # read: block l's dx goes there next
            y, z = r["y"][win], r["z"][win]
            dz, xhat2 = ln_bwd(dcur, z + y, g2[l])
            dy = rowdot(dz, w_ff[l].T) + dz
            dr, xhat1 = ln_bwd(dy, r["rnn"][win] + x_rows, g1[l])
            # 2. the reverse recurrence from the carry of chunk c+1
            dys = dr.reshape(bsz, n, h)
            dgates = torch.empty(bsz, n, 4 * h)
            dcreg = dcn[l] if first else carry[l][(c + 1) % 2][1]
            slots = None
            for j in reversed(range(n)):
                row = brow + t0 + j
                a = r["acts"][row]
                ai, af, ag, ao = a.chunk(4, dim=-1)
                ct = r["cs"][row]
                # c_{t-1}: the window's first step reads the row before it
                cp = r["cs"][row - 1] if t0 + j > 0 else c0[l]
                dh = dys[:, j]
                if j < n - 1:
                    for s in slots:
                        dh = dh + s
                elif first:
                    dh = dh + dhn[l]
                else:
                    for s in carry[l][(c + 1) % 2][0]:
                        dh = dh + s
                tc = torch.tanh(ct)
                dc = dh * ao * (1 - tc * tc) + dcreg
                d = torch.cat([dc * ag * ai * (1 - ai),
                               dc * cp * af * (1 - af),
                               dc * ai * (1 - ag * ag),
                               dh * tc * ao * (1 - ao)], -1)
                dcreg = dc * af
                dgates[:, j] = d
                slots = cell_slots(d, w_hh_t[l], h)
            if c == 0:
                dh = torch.zeros(bsz, h)
                for s in slots:
                    dh = dh + s
                dh0[l], dc0[l] = dh, dcreg
            else:
                carry[l][c % 2] = (slots, dcreg)
            dgates = dgates.reshape(bsz * n, 4 * h)
            # 3. dx into the window's rows of dx0
            dx0[win] = rowdot(dgates, w_ih_t[l].T) + dr
            done.add((l, c))
            # 4. on the side stream: the window's share of the nine
            # parameter gradients
            hprev = r["rnn"][win - 1]
            hprev[win % t == 0] = h0[l][(win // t)[win % t == 0]]
            accumulate("dg2", l, (dcur * xhat2).sum(0))
            accumulate("db2", l, dcur.sum(0))
            accumulate("dbff", l, dz.sum(0))
            accumulate("dwff", l, y.T @ dz)
            accumulate("dg1", l, (dy * xhat1).sum(0))
            accumulate("db1", l, dy.sum(0))
            accumulate("dwih", l, x_rows.T @ dgates)
            accumulate("dwhh", l, hprev.T @ dgates)
            accumulate("dbg", l, dgates.sum(0))
            # no later chunk reads these rows: block l's residuals and
            # its input rows (the residual plane below, or x0)
            for plane in r.values():
                plane[win] = float("nan")
            xin[win] = float("nan")
            side_done.add((l, c))
    assert len(side_done) == nl * chunks

    def stacked(name):
        return torch.stack([grads[(name, l)] for l in range(nl)])

    return (dx0.reshape(bsz, t, h), stacked("dwih"), stacked("dbg"),
            stacked("dwhh"), stacked("dwff"), stacked("dbff"),
            stacked("dg1"), stacked("db1"), stacked("dg2"), stacked("db2"),
            dh0, dc0)


def _cots(args, seed):
    x0, h0 = args[0], args[10]
    rng = np.random.default_rng(seed)

    def r(like):
        return torch.from_numpy(
            rng.standard_normal(tuple(like.shape)).astype(np.float32))

    return r(x0), r(h0), r(h0)


def _emulate(args, cots, chunk):
    with torch.no_grad():
        return emulate_backward(args, forward_residuals(args), *cots, chunk)


# (layers, T): one step, a short and a 16-step sequence, at one, two and
# five blocks
SHAPES = [(1, 1), (1, 7), (1, 16), (2, 1), (2, 7), (2, 16), (5, 1), (5, 7),
          (5, 16)]


@pytest.mark.parametrize("layers,t", SHAPES)
def test_reverse_schedule_matches_reference(layers, t):
    """At C 1, 3 (ragged last chunks) and T: the emulated schedule vs the
    plain backward, and dx0, dh0, dc0 the same bits at every C."""
    args = _args(layers, t, seed=11)
    cots = _cots(args, seed=layers * 100 + t)
    want = mixer_stack.mixer_stack_backward_reference(args, *cots)
    whole = _emulate(args, cots, t)
    for chunk in sorted({1, min(3, t), t}):
        got = whole if chunk == t else _emulate(args, cots, chunk)
        for i, (g, w) in enumerate(zip(got, want)):
            tol = (REF_ATOL if i in STATES
                   else REF_RTOL * max(1.0, float(w.abs().max())))
            assert float((g - w).abs().max()) <= tol, (chunk, i)
        for i in STATES:
            assert torch.equal(got[i], whole[i]), (chunk, i)


@pytest.mark.parametrize("layers,t,chunk", [(2, 1, 1), (2, 7, 3), (2, 16, 16),
                                            (5, 7, 1), (5, 16, 3)])
def test_reverse_schedule_matches_jax_gradients(_interpret, layers, t,
                                                chunk):
    """The emulated schedule vs the VJP of the JAX
    ``mixer_stack_recurrence`` (its Pallas backward in interpret mode),
    weights from the JAX module through ``_stacked``."""
    rng = np.random.default_rng(layers * 10 + t)
    x = rng.standard_normal((3, t, 16)).astype(np.float32)
    h0, c0 = (0.3 * rng.standard_normal((layers, 3, 16)).astype(np.float32)
              for _ in range(2))
    _, _, pm = _pair(layers, 16, np.zeros((3, 16, 16), np.float32),
                     seed=t + 3)
    args = (torch.from_numpy(x), *_stacked(pm), torch.from_numpy(h0),
            torch.from_numpy(c0))
    cots = _cots(args, seed=t)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(pallas_mixer_stack.mixer_stack_recurrence, *jargs)
        want = vjp((jnp.asarray(cots[0].numpy()),
                    (jnp.asarray(cots[1].numpy()),
                     jnp.asarray(cots[2].numpy()))))
    got = _emulate(args, cots, chunk)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=JAX_ATOL,
                                   err_msg=str(i))


def test_residual_rows_are_read_in_turn():
    """A chunk that read a residual row out of turn would see NaN: filling
    block 0's rows of chunk 1 early poisons the result."""
    args = _args(2, 7, seed=4)
    cots = _cots(args, seed=4)
    with torch.no_grad():
        blocks = forward_residuals(args)
        got = emulate_backward(args, blocks, *cots, 3)
        assert all(torch.isfinite(g).all() for g in got)
        assert all(torch.isnan(p).all() for b in blocks for p in b.values())
        blocks = forward_residuals(args)
        blocks[0]["cs"][window_rows(3, 7, 3, 3)] = float("nan")
        got = emulate_backward(args, blocks, *cots, 3)
    assert torch.isnan(got[0]).any()


@pytest.mark.parametrize("b,t,want", [(32, 2016, 128), (32, 252, 64)])
def test_backward_chunk_at_the_training_encoders(b, t, want):
    """The backward at the flagship step's encoder shapes takes the chunk
    measured fastest there."""
    assert mixer_stack.backward_chunk_steps(b, t, 256, 5) == want


def test_backward_chunk_steps_range():
    """1 to T steps; one layer (no lag to hide) runs one chunk; at the
    training encoders the chain (chunks + L - 1) * C is shorter than the
    layer-major L * T."""
    for t in (1, 7, 37, 252, 2016):
        for layers in (1, 2, 5):
            c = mixer_stack.backward_chunk_steps(16, t, 256, layers)
            assert 1 <= c <= t
            assert layers > 1 or c == t
    for t in (252, 2016):
        c = mixer_stack.backward_chunk_steps(32, t, 256, 5)
        assert (-(-t // c) + 4) * c < 5 * t
    with pytest.raises(ValueError):
        mixer_stack.backward_chunk_steps(16, 0, 256, 5)
