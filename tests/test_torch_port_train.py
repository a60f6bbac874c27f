"""PyTorch port: the training slice vs the JAX package, on CPU tensors.

  * the port's plain ``mixer_stack_recurrence`` (what CPU tensors run)
    vs the JAX ``ops/pallas_mixer_stack.py mixer_stack_recurrence`` with
    its Pallas calls in interpret mode (patched as
    tests/test_pallas_mixer_stack.py runs them), forward and all twelve
    input gradients under random cotangents: f32 atol 2e-5;
  * losses, metrics, optimizers and the LR schedule vs ``train/losses.py``,
    ``train/metrics.py`` and ``train/optim.py`` (optax);
  * the slice as a whole: a small Metaformer (2 blocks, hidden 32,
    2-block encoders, T 24, lead 4) with the JAX weights moved over by
    ``state_dict_from_jax``, through three SGD-momentum steps of the
    port's ``train_step`` vs the JAX ``streaming_step_fns`` train_step:
    per-step losses rtol 1e-5, final parameters atol 1e-5. The JAX side
    runs its default TPU configuration, the integrators through the
    rect-attention kernel (``MRGEN_FUSED_ATTN=force``, Pallas in
    interpret mode), as the port's integrators always do; one case keeps
    the JAX package's plain attention (``MRGEN_FUSED_ATTN=0``), and the
    two agree;
  * the faults training exposed in the decode slice: the model is
    trainable, the inference-only kernel wrappers refuse inputs that
    need a gradient, and the mixers honour dropout in training (the
    recurrent stack leaves the fused path, the attention draws masks
    only inside ``dropout_rng``).

The CUDA kernels are held to their plain versions on the card in
tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_mixer_stack
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import losses as jlosses
from multimodalreactiongeneration_tpu.train import metrics as jmetrics
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn.mixers import (
    MHAMixerLayerd,
    RecurrentMixerLayerd,
)
from multimodalreactiongeneration_tpu_torch.ops import (
    decode_rollout as K2,
    mixer_stack as K1,
)
from multimodalreactiongeneration_tpu_torch.train import (
    harness,
    losses,
    metrics,
    optim,
)
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_decode_rollout import _folds, _rollout_inputs
from tests.test_torch_port_weights import flat_params, np_batch, paired_models

torch.set_num_threads(1)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# ---- the encoder stack ---------------------------------------------------

def _stack_inputs(seed, b, t, h, n):
    rng = np.random.default_rng(seed)
    shapes = [(b, t, h), (n, h, 4 * h), (n, 4 * h), (n, h, 4 * h),
              (n, h, h), (n, h), (n, h), (n, h), (n, h), (n, h),
              (n, b, h), (n, b, h)]
    scales = [1, .3, .1, .3, .3, .1, .1, .1, .1, .1, .3, .3]
    args = [(s * rng.standard_normal(x)).astype(np.float32)
            for x, s in zip(shapes, scales)]
    args[6] += 1  # LayerNorm scales around 1
    args[8] += 1
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (n, b, h), (n, b, h))]
    return args, cots


@pytest.mark.parametrize("num_layerd,t", [(2, 16), (3, 21), (5, 33)])
def test_plain_mixer_stack_recurrence_matches_jax(num_layerd, t):
    args, cots = _stack_inputs(t, 3, t, 16, num_layerd)
    jargs = [jnp.asarray(a) for a in args]

    def loss(*a):
        y, (hn, cn) = pallas_mixer_stack.mixer_stack_recurrence(*a)
        return sum(jnp.sum(o * c) for o, c in zip((y, hn, cn), cots))

    y, (hn, cn) = pallas_mixer_stack.mixer_stack_recurrence(*jargs)
    want_grads = jax.grad(loss, argnums=tuple(range(12)))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = K1.launches, K1.train_fwd_launches, K1.bwd_launches
    py, (phn, pcn) = K1.mixer_stack_recurrence(*leaves)
    grads = torch.autograd.grad(
        (py, phn, pcn), leaves, [torch.from_numpy(c) for c in cots])
    assert (K1.launches, K1.train_fwd_launches, K1.bwd_launches) == before
    for got, want in ((py, y), (phn, hn), (pcn, cn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
    names = ("dx0", "dw_ih_t", "db_g", "dw_hh_t", "dw_ff", "db_ff", "dg1",
             "db1", "dg2", "db2", "dh0", "dc0")
    for got, want, name in zip(grads, want_grads, names):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)
    ref = K1.mixer_stack_backward_reference(
        [torch.from_numpy(a) for a in args],
        *[torch.from_numpy(c) for c in cots])
    for got, want in zip(ref, grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- losses, metrics, optimizers ----------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(loss_type="mse"),
    dict(loss_type="mae"),
    dict(loss_type="huber", huber_delta=0.5),
    dict(loss_type="smoothl1", smoothl1_beta=0.7),
])
def test_losses_match_jax(cfg):
    rng = np.random.default_rng(0)
    x = (2 * rng.standard_normal((3, 7, 18))).astype(np.float32)
    y = rng.standard_normal((3, 7, 18)).astype(np.float32)
    want = jlosses.build_loss(cfg)(jnp.asarray(x), jnp.asarray(y))
    got = losses.build_loss(cfg)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_build_loss_refuses_what_jax_refuses():
    for cfg in (dict(loss_type="mse", loss_reduction="sum"),
                dict(loss_type="cosine")):
        with pytest.raises(ValueError):
            jlosses.build_loss(cfg)
        with pytest.raises(ValueError):
            losses.build_loss(cfg)


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    preds = rng.standard_normal((2, 5, 18)).astype(np.float32)
    target = rng.standard_normal((2, 5, 18)).astype(np.float32)
    for centroid in (True, False):
        for angle in (True, False):
            for order in (0, 1, 2):
                td = metrics.gen_target_dict(centroid, angle, order)
                assert td == jmetrics.gen_target_dict(centroid, angle, order)
    td = metrics.gen_target_dict(True, True, 2)
    want = jmetrics.per_slice_sq_err(jnp.asarray(preds), jnp.asarray(target),
                                     td)
    got = metrics.per_slice_sq_err(torch.from_numpy(preds),
                                   torch.from_numpy(target), td)
    assert list(got) == list(want)
    jacc, pacc = jmetrics.MetricAccumulator("train_"), \
        metrics.MetricAccumulator("train_")
    for name, (s, c) in got.items():
        np.testing.assert_allclose(float(s), float(want[name][0]), rtol=1e-6)
        assert float(c) == float(want[name][1])
    for _ in range(2):
        jacc.update(want)
        pacc.update(got)
    j, p = jacc.compute(), pacc.compute()
    assert list(j) == list(p)
    for k in j:
        np.testing.assert_allclose(p[k], j[k], rtol=1e-6)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Two updates on the same gradient trees, a learning-rate change
    between them (the per-epoch schedule's path)."""
    cfg = dict(use_optimizer=kind, lr=1e-2, weight_decay=1e-2, momentum=0.9)
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]

    jopt = joptim.build_optimizer(from_dict(cfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = optim.build_optimizer(tp.values(), cfg)
    for i, g in enumerate(grads):
        if i == 1:
            state = joptim.set_learning_rate(state, 3e-3)
            optim.set_learning_rate(topt, 3e-3)
        updates, state = jopt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_cosine_annealing_matches_jax():
    want = joptim.cosine_annealing(1e-3, 10)
    got = optim.cosine_annealing(1e-3, 10)
    for epoch in range(13):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=1e-6)


def test_delta_scaler_matches_jax():
    for order, scale in ((2, 4.0), (1, 2.0), (0, 3.0)):
        np.testing.assert_allclose(
            harness.delta_scaler(18, order, scale).numpy(),
            np.asarray(jharness.delta_scaler(18, order, scale)), rtol=1e-7)


# ---- the slice as a whole ----------------------------------------------

LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS_CFG = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD_CFG = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)


def _train_batch(seed):
    """T 24, lead 4; 10% of the target frames and the tail of one self-
    motion stream are padding (-100)."""
    batch = np_batch(seed, T=24, lead=4)
    rng = np.random.default_rng(seed + 1)
    batch[6][rng.random(batch[6].shape[:2]) < 0.1] = -100.0
    batch[2][1, -3:] = -100.0
    return batch


def test_train_step_matches_jax(monkeypatch):
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    _check_train_step_matches_jax()


def test_train_step_matches_jax_plain_attention(monkeypatch):
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "0")
    _check_train_step_matches_jax()


def _check_train_step_matches_jax():
    batch = _train_batch(50)
    jm, params, pm = paired_models(MF_CFG, 51, batch)
    model_cfg = dict(MF_CFG, **LOSS_CFG)

    jopt = joptim.build_optimizer(from_dict(SGD_CFG))
    jtrain, jeval = jharness.streaming_step_fns(
        jm, model_cfg, METRICS_CFG, jopt, mask_self_motion_input=True)
    jtrain = jax.jit(jtrain)
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in batch]
    state = jopt.init(params)

    popt = optim.build_optimizer(pm.parameters(), SGD_CFG)
    ptrain, peval = harness.streaming_step_fns(
        pm, model_cfg, METRICS_CFG, popt, mask_self_motion_input=True)
    pbatch = [(torch.from_numpy(x), None) for x in batch]

    rng = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        for step in range(3):
            params, state, jloss, jslices = jtrain(params, state, jbatch,
                                                   rng)
            ploss, pslices = ptrain(pbatch)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=1e-5, err_msg=f"step {step}")
        for name, (s, c) in pslices.items():
            np.testing.assert_allclose(float(s), float(jslices[name][0]),
                                       rtol=1e-4, err_msg=name)
            assert float(c) == float(jslices[name][1])
        jeval_loss, _ = jeval(params, jbatch)
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    peval_loss, _ = peval(pbatch)
    assert not pm.training
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


def test_step_fns_refuse_bf16_and_remat():
    """The step functions take f32 or bf16 and refuse any other compute
    dtype; no model refuses bf16 any more: the GRU Metaformer's bf16 step
    trains (held to JAX's in tests/test_torch_port_bf16_gru.py, the LSTM
    Metaformer's in tests/test_torch_port_bf16_flagship.py) and leaves
    its parameters f32; remat is ported: its step gives the plain step's
    loss, bit for bit (tests/test_torch_port_train_options.py holds it to
    JAX)."""
    model_cfg = dict(MF_CFG, **LOSS_CFG)
    batch = [(torch.from_numpy(x), None) for x in _train_batch(61)]
    gru_cfg = dict(MF_CFG, emb_mixers=["gru"] * 3)
    losses = []
    for remat in (False, True):
        pm = Metaformer(MF_CFG, generator=torch.Generator().manual_seed(0),
                        device="cpu")
        opt = optim.build_optimizer(pm.parameters(), SGD_CFG)
        gru = Metaformer(gru_cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
        gru_opt = optim.build_optimizer(gru.parameters(), SGD_CFG)
        with pytest.raises(ValueError, match="f32 or bf16"):
            harness.streaming_step_fns(
                gru, dict(gru_cfg, **LOSS_CFG), METRICS_CFG, gru_opt, True,
                compute_dtype=torch.float16)
        gru_step, _ = harness.streaming_step_fns(
            gru, dict(gru_cfg, **LOSS_CFG), METRICS_CFG, gru_opt, True,
            compute_dtype=torch.bfloat16, remat=remat)
        assert np.isfinite(float(gru_step(batch)[0]))
        assert {p.dtype for p in gru.parameters()} == {torch.float32}
        step, _ = harness.streaming_step_fns(pm, model_cfg, METRICS_CFG, opt,
                                             True, remat=remat)
        losses.append(float(step(batch)[0]))
    assert losses[0] == losses[1]


# ---- faults of the decode slice that training exposed ----------------------

def test_metaformer_trains_every_parameter():
    """The constructor leaves the model trainable; one backward gives
    every parameter a gradient, the encoder stacks' included (CPU
    tensors: autograd records through the plain stack)."""
    pm = Metaformer(MF_CFG, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    assert pm.training
    assert all(p.requires_grad for p in pm.parameters())
    batch = [torch.from_numpy(x) for x in _train_batch(60)]
    y, _ = pm(*batch[:6])
    y[:, 4:].square().mean().backward()
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        if ".emb_1." in name or ".emb_2." in name or ".emb_0." in name:
            assert float(p.grad.abs().max()) > 0, name


def test_inference_kernel_wrappers_refuse_inputs_that_need_grad():
    args, _ = _stack_inputs(0, 2, 16, 16, 2)
    targs = [torch.from_numpy(a) for a in args]
    targs[1].requires_grad_()
    with pytest.raises(RuntimeError, match="mixer_stack_recurrence"):
        K1.mixer_stack_forward(*targs)
    with torch.no_grad():
        K1.mixer_stack_forward(*targs)

    _, pf = _folds(MF_CFG, 31)
    arrays, kw = _rollout_inputs(MF_CFG, 32, np.ones(4, bool), steps=4)
    tensors = [torch.from_numpy(a) for a in arrays]
    tensors[4].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        K2.decode_rollout(pf, *tensors, **kw)
    with torch.no_grad():
        K2.decode_rollout(pf, *tensors, **kw)


@pytest.mark.parametrize("kind", ["lstm", "mha"])
def test_mixers_refuse_dropout_in_training(kind, monkeypatch):
    """Dropout in training: the recurrent stack leaves the fused stack
    for its blocks (JAX's gate; its single-layer blocks draw no mask), so
    the output is the eval-mode output; the attention drops its context,
    with masks drawn only inside ``dropout_rng`` (outside it, raises)."""
    from multimodalreactiongeneration_tpu_torch.nn import mixers
    from multimodalreactiongeneration_tpu_torch.nn.basic import dropout_rng

    gen = torch.Generator().manual_seed(0)
    common = dict(hidden_size=16, generator=gen, num_layerd=2, dropout=0.1,
                  residual=True, residual_layer_norm=True)
    x = torch.randn(2, 20, 16, generator=gen)
    if kind == "lstm":
        mod = RecurrentMixerLayerd(**common)
        run = lambda: mod(x)
    else:
        mod = MHAMixerLayerd(num_heads=2, **common)
        run = lambda: mod(x, x, x)
    fused = mixers.mixer_stack_recurrence
    monkeypatch.setattr(mixers, "mixer_stack_recurrence", None)
    if kind == "mha":
        with pytest.raises(RuntimeError, match="dropout_rng"):
            run()
    with dropout_rng(0):
        y_train, _ = run()
    mod.eval()
    monkeypatch.setattr(mixers, "mixer_stack_recurrence", fused)
    y, _ = run()
    assert y.shape == y_train.shape == x.shape
    if kind == "lstm":
        torch.testing.assert_close(y_train, y)
    else:
        assert not torch.equal(y_train, y)
