"""PyTorch port: the bf16 mixed-precision training step of the flagship
Metaformer (LSTM embeddings) vs the JAX package on the CPU, its kernels'
plain bf16 versions, and its CLI.

The JAX side runs as its own tests run it: the Pallas calls in interpret
mode, ``MRGEN_RNN_IMPL=pallas`` and ``MRGEN_FUSED_ATTN=force``, so its
encoder stacks take ``mixer_stack_recurrence`` (K3/K4), its self-motion
LSTMs ``lstm_layer`` (K7) and its integrators ``rect_attention`` (K5/K6),
as the port's do. The kernel-level cases run JAX eagerly; the step is
compiled with ``xla_allow_excess_precision`` off (as
tests/test_torch_port_bf16_train.py says why), so JAX rounds where its
program says.

  * The plain bf16 encoder stack (``ops/mixer_stack.py``: bf16 W_ih, W_hh
    and W_ff, the rest f32) vs JAX's, forward and all twelve gradients,
    at the (L, T) cases of tests/test_torch_port_train.py: both round the
    same operands and sum in f32, so outputs agree to f32 rounding (atol
    2e-5; observed 7e-7), the f32 gradients within 2e-5 of their largest
    magnitude (observed 1.3e-5), the bf16 dW within 1e-2 of their largest
    (one bf16 ulp; observed 2e-4); every gradient in JAX's dtype.
  * The plain bf16 rect attention (``ops/rect_attention.py``) vs JAX's,
    for the all-bf16 call (block 0's integrators) and the f32-q / bf16-k,v
    call (the later blocks'): the f32 context atol 2e-5 (observed 6e-7),
    the bf16 gradients within 1e-2 of their largest (observed 1e-4), the
    f32 dq atol 2e-5 (observed 6e-7); gradients in q's, k's and v's
    dtypes.
  * The plain bf16 stack at full depth (L5) over its first
    ``MODE_STEPS`` steps: near JAX's and near itself on inputs moved by
    one f32 ulp, within chip_smoke.py's distance bound (``BF16_MODE_FRAC``
    of the plain f32 version's distance), where the card's distance test
    reads K3 at full depth.
  * The whole step: a Metaformer at hidden 128 (K7's route needs
    128-aligned sizes; below it both sides take K8, which has no bf16
    mode), 2 blocks, 2-block encoders, T 24, lead 4, three SGD updates
    against JAX's bf16 step, plain and with ``remat=True`` and with
    ``accumulate_grad_batches=2``. Before each update the port takes
    JAX's parameters (each side keeps its own optimizer state): a bf16
    step is chaotic, a rounding flip on either side moves the bf16 copy
    of a parameter by a bf16 ulp and the next steps amplify it, so
    parameters carried across updates hold no bound that also rejects the
    f32 step (after three unsynced updates, over 12 model seeds and the
    remat and accumulation cases: the port 0.9-9.3% of JAX's largest
    change, JAX against itself from parameters moved by one f32 ulp
    0.6-14%, the port's f32 step 2.0-17%; tests/bf16_step_survey.py).
    Per update: losses rtol 2e-3 (observed at most 2.5e-5); the
    parameters f32; each kernel entry's operand dtypes JAX's (spied on
    both sides); every parameter within ``MOVE_FRAC`` of the largest
    change JAX's update made to it and, on average, within ``MEAN_FRAC``
    of its mean change; the eval step (f32) on JAX's final parameters
    rtol 1e-5. Synced, over the same runs, the port read 1.2-3.7% on the
    largest and 0.5-1.4% on the mean, JAX against itself 0.8-22% and
    1.0-11%, the port's f32 step 2.6-26% and 1.6-15% (17.9% and 9.8% at
    ``STEP_SEED``, where it is the control the bounds must reject). A 2%
    bound on the largest is exceeded on 3 of the 12 seeds (2.0% and 2.2%
    on biases, 3.7% on ``feature_embedding_0.weight`` at the third
    update). The biases of the Dense layers that compute in bf16 lead
    most seeds' readings: XLA's CPU backend sums their gradients in bf16
    (``test_jax_sums_bf16_bias_gradients_in_bf16``), the port in f32. The
    k projections' biases are held to 1e-6 absolute instead: softmax is
    shift invariant per row, so their gradient is zero in exact
    arithmetic and both sides move them by rounding noise alone
    (observed at most 2.2e-7 synced, 5.2e-7 unsynced).
  * The training CLI with ``trainer.precision=bf16`` on the flagship
    config trains, writes f32 checkpoints (parameters and optimizer
    state) and resumes from them bit for bit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_lstm as jlstm
from multimodalreactiongeneration_tpu.ops import pallas_mixer_stack as jstack
from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import attention as patt
from multimodalreactiongeneration_tpu_torch.nn import mixers as pmix
from multimodalreactiongeneration_tpu_torch.nn import recurrent as prec
from multimodalreactiongeneration_tpu_torch.nn.basic import Dense
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack as K1
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from tests.fixtures import make_synthetic_corpus
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_rect_attention import CASES, HEADS, _inputs
from tests.test_torch_port_train import (
    LOSS_CFG,
    METRICS_CFG,
    SGD_CFG,
    _stack_inputs,
    _train_batch,
)
from tests.test_torch_port_weights import flat_params, paired_models

torch.set_num_threads(1)
BF = torch.bfloat16
ATOL = 2e-5
BF16_REL = 1e-2
# JAX's bf16 bounds (tests/test_pallas_lstm.py:130): outputs, f32 and bf16
# gradients, absolute
LONG_TOL = (5e-2, 5e-2, 0.3)
# chip_smoke.py's distance test of a bf16 mode, and the steps it reads at
# the full depth of the encoder stack (BF16_MODE_FRAC, BF16_MODE_STEPS)
BF16_MODE_FRAC, MODE_STEPS = 0.25, 4
LOSS_RTOL = 2e-3
MOVE_FRAC, MEAN_FRAC = 4e-2, 2e-2  # the module docstring
STEP_SEED = 51
NOISE_ATOL = 1e-6  # the k projections' biases (the module docstring)
CFG = dict(MF_CFG, hidden_size=128)
YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "lstmformer.yaml")


@pytest.fixture(autouse=True)
def _kernel_routes(monkeypatch):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    """A JAX array as a torch tensor of the same dtype (f32 or bf16)."""
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(BF) if x.dtype == jnp.bfloat16 else t


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _grads_match(got, want, short=True):
    """Each gradient in JAX's dtype; bf16 ones within BF16_REL of their
    largest magnitude, f32 ones within ATOL of it (at least ATOL); past a
    short sequence JAX's own bf16 bounds (``LONG_TOL``)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert _dtype_name(g) == str(w.dtype), i
        lowp = str(w.dtype) == "bfloat16"
        g, w = g.float().numpy(), _np(w)
        err = np.abs(g - w).max()
        if not short:
            assert err <= LONG_TOL[2 if lowp else 1], i
        else:
            rel = BF16_REL if lowp else ATOL
            assert err <= rel * max(1.0, np.abs(w).max()), i


# ---- the encoder stack (K3/K4) ------------------------------------------

@pytest.mark.parametrize("num_layerd,t", [(2, 16), (3, 21), (5, 33)])
def test_plain_bf16_mixer_stack_matches_jax(num_layerd, t):
    """Tight to T 21; at L5 x T33 an h on a bf16 rounding boundary may
    round the other way in one of them and the flip compounds through the
    chain and the blocks (dx0 4.2e-3 of 8.3): JAX's bf16 bounds."""
    short = t <= 21
    args, cots = _stack_inputs(t, 3, t, 16, num_layerd)
    jargs = [jnp.asarray(a) for a in args]
    for i in K1._WEIGHTS:
        jargs[i] = jargs[i].astype(jnp.bfloat16)

    def loss(*a):
        y, (hn, cn) = jstack.mixer_stack_recurrence(*a)
        return sum(jnp.sum(o * c) for o, c in zip((y, hn, cn), cots))

    y, (hn, cn) = jstack.mixer_stack_recurrence(*jargs)
    want_grads = jax.grad(loss, argnums=tuple(range(12)))(*jargs)
    leaves = [_torch(a).requires_grad_() for a in jargs]
    py, (phn, pcn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad(
        (py, phn, pcn), leaves, [torch.from_numpy(c) for c in cots])
    for got, want in ((py, y), (phn, hn), (pcn, cn)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   atol=ATOL if short else LONG_TOL[0])
    _grads_match(grads, want_grads, short)


@pytest.mark.parametrize("b", [3, 32])
def test_plain_bf16_mixer_stack_first_steps_near_jax_at_depth(b):
    """Over L5 a rounding flip compounds through the layers within a few
    steps, so the bf16 mode's distance test (the kernel's ys on average
    within ``BF16_MODE_FRAC`` of the plain f32 version's distance from the
    plain bf16 ys, chip_smoke.py) reads the first ``MODE_STEPS`` steps at
    full depth. There two faithful bf16 stacks, the port's plain version
    and JAX's, differ by 0.021 (B3) and 0.071 (B32) of that distance, and
    moving every input by one f32 ulp moves the plain version 0.137 and
    0.069 of it; over the first 16 steps the readings grow to 0.19-0.26
    and 0.16-0.21. An f32-operand kernel reads 1."""
    n, t, h = 5, 16, 256
    rng = np.random.default_rng(n)

    def r(*shape, s=1.0, mean=0.0):
        return torch.from_numpy(
            (mean + s * rng.standard_normal(shape)).astype(np.float32))

    args = [r(b, t, h), r(n, h, 4 * h, s=.06), r(n, 4 * h, s=.06),
            r(n, h, 4 * h, s=.06), r(n, h, h, s=.06), r(n, h, s=.1),
            r(n, h, s=.1, mean=1.), r(n, h, s=.1), r(n, h, s=.1, mean=1.),
            r(n, h, s=.1), r(n, b, h, s=.3), r(n, b, h, s=.3)]
    args = [a.to(BF) if i in K1._WEIGHTS else a for i, a in enumerate(args)]
    moved = [torch.nextafter(args[0], torch.tensor(np.inf)), *args[1:]]
    with torch.no_grad():
        y, y32, y_moved = (K1.mixer_stack_forward_reference(*a)[0] for a in (
            args, [a.float() for a in args], moved))
    jargs = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if i in K1._WEIGHTS else jnp.float32)
        for i, a in enumerate(args)]
    y_jax = torch.from_numpy(np.asarray(
        jstack.mixer_stack_recurrence(*jargs)[0]))
    w = slice(0, MODE_STEPS)
    gap = float((y32[:, w] - y[:, w]).abs().mean())
    for other in (y_jax, y_moved):
        assert float((other[:, w] - y[:, w]).abs().mean()) <= (
            BF16_MODE_FRAC * gap)


# ---- rect attention (K5/K6) ------------------------------------------------

@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("lq,lk", CASES)
def test_plain_bf16_rect_attention_matches_jax(lq, lk, q_dtype):
    q, k, v, q_pad, k_pad, g = _inputs(lq, lk, CASES.index((lq, lk)))
    jq = jnp.asarray(q).astype(q_dtype)
    jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    out, vjp = jax.vjp(
        lambda a, b, c: jra.rect_attention(HEADS, a, b, c, jnp.asarray(q_pad),
                                           jnp.asarray(k_pad)), jq, jk, jv)
    want_grads = vjp(jnp.asarray(g))
    leaves = [_torch(x).requires_grad_() for x in (jq, jk, jv)]
    got = K5.rect_attention(HEADS, *leaves, torch.from_numpy(q_pad),
                            torch.from_numpy(k_pad))
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), _np(out), atol=ATOL)
    _grads_match(grads, want_grads)


def test_jax_sums_bf16_bias_gradients_in_bf16():
    """A bf16 Dense's bias gradient, the transpose of the bias broadcast:
    JAX's is a bf16 ``reduce``, which XLA's CPU backend accumulates in
    bf16, over a (rows, features) cotangent in runs of 32 rows (each run
    summed in order, then the runs' sums in order; bit for bit); the port
    sums in f32 and rounds once, as torch's bf16 sums do. The two differ
    in most elements (observed 78%, up to 6.3e-3 of the largest) and lead
    the step test's readings on those biases."""
    ct = np.random.default_rng(0).standard_normal((448, 128)).astype(
        np.float32)
    jct = jnp.asarray(ct).astype(jnp.bfloat16)
    bias = jnp.zeros(128, jnp.bfloat16)
    vjp = jax.jit(lambda c: jax.vjp(lambda b: jct + b, bias)[1](c)[0]).lower(
        jct).compile(compiler_options={"xla_allow_excess_precision": False})
    got = _np(vjp(jct))
    rows = _np(jct)

    def bf16(x):
        return _np(jnp.asarray(np.float32(x)).astype(jnp.bfloat16))

    total = np.zeros(128, np.float32)
    for start in range(0, len(rows), 32):
        run = np.zeros(128, np.float32)
        for row in rows[start:start + 32]:
            run = bf16(run + row)
        total = bf16(total + run)
    np.testing.assert_array_equal(got, total)
    dense = Dense(4, 128).to(BF)
    (g,) = torch.autograd.grad(dense(torch.zeros(448, 4, dtype=BF)),
                               dense.bias, torch.tensor(rows).to(BF))
    np.testing.assert_array_equal(g.float().numpy(),
                                  bf16(rows.astype(np.float64).sum(0)))
    assert (got != g.float().numpy()).mean() > 0.5


# ---- the whole step -------------------------------------------------------

def _spy(log, fn, skip=0):
    """fn, recording the dtypes of its tensor arguments (after ``skip``)."""
    def wrapped(*args, **kw):
        log.append(tuple(str(a.dtype).replace("torch.", "")
                         for a in args[skip:] if hasattr(a, "dtype")))
        return fn(*args, **kw)
    return wrapped


# the flagship's kernel entries, (module, attribute, leading non-tensor
# arguments) on each side, and the calls of each in one forward
FLAGSHIP_SPIES = {
    "jax": ((jstack, "mixer_stack_recurrence", 0), (jlstm, "lstm_layer", 0),
            (jra, "rect_attention", 1)),
    "port": ((pmix, "mixer_stack_recurrence", 0), (prec, "lstm_layer", 0),
             (patt, "rect_attention", 1)),
    "calls": [2, 2, 4]}


def _spy_kernel_entries(monkeypatch, spies=FLAGSHIP_SPIES):
    """Record each kernel entry's operand dtypes on both sides: the JAX
    module attributes its models import at call time, and the port's."""
    logs = {"jax": [], "port": []}
    for side in ("jax", "port"):
        for mod, name, skip in spies[side]:
            log = []
            logs[side].append(log)
            monkeypatch.setattr(mod, name, _spy(log, getattr(mod, name),
                                                skip))
    return logs


def _jax_pairs(batch):
    return [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32)) for x in batch]


class _JaxMoved:
    """JAX's bf16 step from parameters moved by one f32 ulp: the step's
    own sensitivity, for ``_step_readings``."""

    def __init__(self, jtrain, params, state, key):
        self.jtrain, self.key = jtrain, key
        self.params, self.state = self.nudge(params), state

    @staticmethod
    def nudge(params):
        return jax.tree_util.tree_map(lambda a: jnp.nextafter(a, jnp.inf),
                                      params)

    def step(self, batch):
        self.params, self.state, loss, _ = self.jtrain(
            self.params, self.state, _jax_pairs(batch), self.key)
        return loss

    def state_dict(self):
        return state_dict_from_jax(flat_params(self.params))

    def take(self, params):
        self.params = self.nudge(params)


def _step_readings(seed, remat, accumulate, sides, monkeypatch=None,
                   sync=True, cfg=CFG, spies=FLAGSHIP_SPIES, pair=None,
                   make_batch=_train_batch, mask=True):
    """Three optimizer steps (each of ``accumulate`` micro-steps) of JAX's
    bf16 step and of each of ``sides`` (the port's step in a compute
    dtype, or "jax_moved": ``_JaxMoved``) on two alternating batches, from
    the same parameters (model seed ``seed``). With ``sync`` every side
    takes JAX's parameters before each optimizer step (its optimizer state
    stays its own) and is read after each; else it runs on and is read
    after the last. Returns, per side, the largest relative loss
    difference over the micro-steps and the largest ``err / moved`` over
    the readings and parameters (err: the largest difference from JAX's
    parameters; moved: the largest change JAX's steps since the last
    reading made to the parameter) and of the same ratio of the mean
    differences, each with its parameter and step; the k projections'
    biases apart (``NOISE_ATOL``, their largest absolute difference); the
    kernel entries' operand dtypes on both sides (``monkeypatch`` given;
    ``spies`` names the entries); the last JAX parameters and eval step.
    ``cfg``: the model's config; ``pair(seed, batch)``: (JAX module, its
    parameters, the port's model) of that config, by default the
    Metaformer's (``paired_models``); ``make_batch(seed)``: a batch;
    ``mask``: ``mask_self_motion_input``."""
    pair = pair or functools.partial(paired_models, cfg)
    batches = [make_batch(50), make_batch(60)]
    jm, params, _ = pair(seed, batches[0])
    models = [pair(seed, batches[0])[2] for _ in sides]
    logs = _spy_kernel_entries(monkeypatch, spies) if monkeypatch else None
    model_cfg = dict(cfg, **LOSS_CFG)
    jopt = joptim.build_optimizer(from_dict(SGD_CFG),
                                  accumulate_grad_batches=accumulate)
    jtrain, jeval = jharness.streaming_step_fns(
        jm, model_cfg, METRICS_CFG, jopt, mask_self_motion_input=mask,
        compute_dtype=jnp.bfloat16, remat=remat)
    state = jopt.init(params)
    key = jax.random.PRNGKey(0)
    jtrain = jax.jit(jtrain).lower(
        params, state, _jax_pairs(batches[0]), key).compile(
            compiler_options={"xla_allow_excess_precision": False})
    runs = {}
    for side, pm in zip(sides, models):
        if side == "jax_moved":
            runs[side] = _JaxMoved(jtrain, params, state, key)
            continue
        popt = optim.build_optimizer(pm.parameters(), SGD_CFG,
                                     accumulate_grad_batches=accumulate)
        ptrain = harness.streaming_step_fns(
            pm, model_cfg, METRICS_CFG, popt, mask_self_motion_input=mask,
            compute_dtype=side, remat=remat)[0]
        pm.step = lambda b, f=ptrain: f(
            [(torch.from_numpy(x), None) for x in b])[0]
        pm.take = lambda p, m=pm: m.load_state_dict(
            state_dict_from_jax(flat_params(p)))
        runs[side] = pm
    read = {s: dict(loss=0.0, move=(0.0, None), mean=(0.0, None), noise=0.0)
            for s in sides}
    before = state_dict_from_jax(flat_params(params))
    steps = 3 * accumulate
    for step in range(steps):
        batch = batches[step % 2]
        params, state, jloss, _ = jtrain(params, state, _jax_pairs(batch),
                                         key)
        for side, run in runs.items():
            loss = run.step(batch)
            r = read[side]
            r["loss"] = max(r["loss"], abs(float(loss) / float(jloss) - 1))
            if step == 0 and logs and not remat and side == sides[0]:
                # JAX traced the forward once; the port's first step ran
                # it once
                assert logs["port"] == logs["jax"]
                assert [len(x) for x in logs["jax"]] == spies["calls"]
        if (step + 1) % accumulate or not (sync or step + 1 == steps):
            continue
        want = state_dict_from_jax(flat_params(params))
        for side, run in runs.items():
            r = read[side]
            got = run.state_dict()
            assert set(got) == set(want)
            for name, value in got.items():
                value = torch.as_tensor(np.asarray(value))
                assert value.dtype == torch.float32, name
                err = float((value - want[name]).abs().max())
                if name.endswith("k_proj_bias"):
                    r["noise"] = max(r["noise"], err)
                    continue
                change = want[name] - before[name]
                moved = float(change.abs().max())
                assert moved > 0, name
                if err / moved >= r["move"][0]:
                    r["move"] = err / moved, (name, step)
                mean = float((value - want[name]).abs().mean()
                             / change.abs().mean())
                if mean >= r["mean"][0]:
                    r["mean"] = mean, (name, step)
            if sync:
                run.take(params)
        before = want
    return read, params, jeval


@pytest.mark.parametrize("remat,accumulate", [
    (False, 1), (True, 1), (False, 2),
])
def test_bf16_flagship_step_matches_jax(remat, accumulate, monkeypatch):
    """Three bf16 SGD updates (with remat, or accumulating 2 micro-steps
    into each), each from JAX's parameters; on the CPU the plain bf16
    versions of K3/K4, K5/K6 and K7 run, no kernel. The plain case also
    runs the port's f32 step as the control the bound must reject."""
    launches = (K1.train_fwd_launches, K1.bf16_train_fwd_launches,
                K5.fwd_launches, K5.bf16_fwd_launches)
    sides = [torch.bfloat16] + [torch.float32] * (not remat
                                                  and accumulate == 1)
    read, params, jeval = _step_readings(STEP_SEED, remat, accumulate, sides,
                                         monkeypatch)
    assert (K1.train_fwd_launches, K1.bf16_train_fwd_launches,
            K5.fwd_launches, K5.bf16_fwd_launches) == launches
    bf16 = read[torch.bfloat16]
    assert bf16["loss"] <= LOSS_RTOL, bf16
    assert bf16["move"][0] <= MOVE_FRAC, bf16
    assert bf16["noise"] <= NOISE_ATOL, bf16
    assert bf16["mean"][0] <= MEAN_FRAC, bf16
    if torch.float32 in read:  # the control
        f32 = read[torch.float32]
        assert f32["move"][0] > MOVE_FRAC and f32["mean"][0] > MEAN_FRAC, f32
    # the eval step (f32) on JAX's parameters
    pm = paired_models(CFG, STEP_SEED, _train_batch(50))[2]
    pm.load_state_dict(state_dict_from_jax(flat_params(params)))
    batch = _train_batch(50)
    jeval_loss, _ = jax.jit(jeval)(params, _jax_pairs(batch))
    peval_loss, _ = harness.streaming_step_fns(
        pm, dict(CFG, **LOSS_CFG), METRICS_CFG,
        optim.build_optimizer(pm.parameters(), SGD_CFG),
        mask_self_motion_input=True)[1](
            [(torch.from_numpy(x), None) for x in batch])
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


# ---- the CLI --------------------------------------------------------------

SMALL = [
    "device=cpu", "hidden_size=128", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24", "model.num_block=1",
    "model.encoder_num_layer=2", "trainer.precision=bf16",
    "callbacks.save_top_k=1",
]


def _last(path):
    return torch.load(path, weights_only=True)


def test_flagship_cli_bf16_trains_checkpoints_f32_and_resumes(tmp_path,
                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["--config", os.path.abspath(YAML), "name=mf",
              f"data_dir={corpus}", "log_dir=log", *SMALL]
    before = K1.bf16_train_fwd_launches, K5.bf16_fwd_launches
    cli.main(common + ["ckpt_path=a", "max_epochs=1"])
    first = _last(tmp_path / "a" / "mf" / "last")
    assert first["epoch"] == 0 and first["opt"]["state"]
    assert all(v.dtype == torch.float32 for v in first["params"].values())
    for s in first["opt"]["state"].values():
        assert all(v.dtype == torch.float32 for v in s.values()
                   if torch.is_tensor(v) and v.is_floating_point())
    # on the CPU the plain versions run: no kernel launch is counted
    assert (K1.bf16_train_fwd_launches, K5.bf16_fwd_launches) == before
    torch.save(first, tmp_path / "epoch0")
    ends = []
    for run in ("b", "c"):
        resumed = cli.main(common + [f"ckpt_path={run}", "max_epochs=2",
                                     f"resume_from={tmp_path / 'epoch0'}"])
        assert [r["epoch"] for r in resumed.history] == [1]
        assert np.isfinite(resumed.history[0]["train_loss"])
        assert np.isfinite(resumed.history[0]["val_loss"])
        ends.append(_last(tmp_path / run / "mf" / "last"))
    assert ends[0]["epoch"] == ends[1]["epoch"] == 1
    for name, value in ends[0]["params"].items():
        assert value.dtype == torch.float32, name
        assert torch.equal(ends[1]["params"][name], value), name
        assert not torch.equal(first["params"][name], value), name
