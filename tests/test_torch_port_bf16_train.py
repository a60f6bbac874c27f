"""PyTorch port: the bf16 mixed-precision training step of
lstm_with_sampling vs the JAX package on the CPU, also on K8's route,
and its CLI.

The JAX side: ``streaming_step_fns(compute_dtype=jnp.bfloat16)`` under
``MRGEN_RNN_IMPL=pallas`` with the Pallas calls in interpret mode, so its
sampler takes the stacked kernel (K9) and its layered blocks ``lstm_layer``
(K7), as the port's do. The model is the JAX tests' small lws config at
hidden 128 (K7's route needs 128-aligned sizes; below it both take K8)
over 16 motion frames and a lead of 2 (the sampler runs 144 steps, the
blocks 18).

The JAX step is compiled with ``xla_allow_excess_precision`` off. With it
on (XLA's default), the CPU compiler keeps f32 through fused chains where
the program says bf16, and JAX's "bf16" step lands nearer the port's f32
step (within 1.3% of each parameter's change over 3 steps) than its bf16
one (within 6.4%); off, JAX rounds where its program says, as eager
PyTorch does, and the two bf16 steps agree within 0.8%.

  * three SGD steps: per-step losses rtol 2e-3 (observed 3e-4) and every
    parameter within 2% of the largest change JAX's steps made to it
    (observed 0.74%: bf16 gradients carry 8 bits, and where the two sum
    in another order a gradient can round to the neighbouring bf16
    value); the parameters stay f32; the eval step (f32) rtol 1e-5;
  * the same with ``remat=True``, and with ``accumulate_grad_batches=2``
    (JAX's ``MultiSteps``), which compose with bf16 as in JAX;
  * under ``MRGEN_FUSED_DW=0``, where both sides' layered blocks take
    K8's bf16 route (``lstm_recurrence`` with bf16 W_hh) and the sampler
    K9's, each entry's operand dtypes spied on both sides: three updates,
    the port taking JAX's parameters before each (the flagship test's
    ``_step_readings``): every parameter within ``SYNCED_MOVE_FRAC`` (2%)
    of the largest change JAX's update made to it and on average within
    ``SYNCED_MEAN_FRAC`` (1%) of its mean change, bounds the port's f32
    step, the control, must exceed (the 2% bound on three unsynced
    updates above does not reject it: over 12 model seeds it read inside
    at 8). Over those seeds, synced (tests/bf16_step_survey.py ``--model
    lws_k8``), the bf16 step read 1.07-1.61% on the largest (always a
    bias: XLA's CPU backend sums bf16 bias gradients in bf16) and
    0.49-0.76% on the mean, JAX against itself from parameters moved by
    one f32 ulp 0.45-13% and 0.73-9.1%, the f32 step 1.4-15% and
    0.83-9.1% (13.2% and 6.4% at model seed 52, the test's; beyond both
    bounds at 7 of the 12 seeds, the flagship's 4% and 2% at 4): at this
    size one f32 update can land as near JAX's bf16 update as the port's
    bf16 one, so the dtype spies carry the rest;
  * the training CLI with ``trainer.precision=bf16``: trains, writes f32
    checkpoints (parameters and optimizer state), and resumes from them:
    two runs resumed from one checkpoint end bit for bit alike (a resumed
    run does not retrace the unbroken one: the loader reshuffles from
    ``seed + epochs run in the process``, as JAX's does); with scheduled
    sampling the step trains in f32, as JAX's CLI does;
  * no trained model refuses bf16: the LSTM Metaformer's bf16 step is held
    to JAX's in tests/test_torch_port_bf16_flagship.py, the GRU
    Metaformer's and the flagship's on K8's route in
    tests/test_torch_port_bf16_gru.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.ops import pallas_lstm as jlstm
from multimodalreactiongeneration_tpu.ops import (
    pallas_lstm_stacked as jstacked,
)
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import recurrent as prec
from multimodalreactiongeneration_tpu_torch.ops import lstm_layer as K7
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from tests.fixtures import make_synthetic_corpus
from tests.test_torch_port_bf16_flagship import _step_readings
from tests.test_streaming_models import LWS_CFG
from tests.test_torch_port_weights import flat_params, np_batch

torch.set_num_threads(1)
CFG = dict(LWS_CFG, sampler_num_layers=2, hidden_size=128)
LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS_CFG = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD_CFG = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)
LOSS_RTOL = 2e-3
MOVE_FRAC = 2e-2
SYNCED_MOVE_FRAC, SYNCED_MEAN_FRAC = 2e-2, 1e-2  # the module docstring
# the kernel entries of the K8 route's step on both sides, and the calls
# of each in one forward: the sampler's stacked LSTM, the layered blocks'
# K8 recurrences
K8_SPIES = {"jax": ((jstacked, "lstm_stacked_recurrence", 0),
                    (jlstm, "lstm_recurrence", 0)),
            "port": ((prec, "lstm_stacked_recurrence", 0),
                     (K8, "lstm_recurrence", 0)),
            "calls": [1, 2]}
YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "lstm_with_sampling.yaml")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _batch(seed):
    batch = np_batch(seed, T=16, lead=2)
    rng = np.random.default_rng(seed + 1)
    batch[6][rng.random(batch[6].shape[:2]) < 0.1] = -100.0
    return batch


def _pair(seed, batch):
    jm = JaxLSTMwithSample(cfg=CFG)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in batch[:6]])
    pm = LSTMwithSample(CFG, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm


def _jax_pairs(batch):
    return [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
            for x in batch]


def _compile_exact(fn, *args):
    """``fn`` jitted with XLA rounding where the program says (the module
    docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _params_within(pm, params, params0):
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        assert value.dtype == torch.float32, name
        moved = float((want[name] - params0[name]).abs().max())
        assert moved > 0, name
        err = float((value - want[name]).abs().max())
        assert err <= MOVE_FRAC * moved, (name, err, moved)


@pytest.mark.parametrize("remat,accumulate", [
    (False, 1), (True, 1), (False, 2),
])
def test_bf16_train_step_matches_jax(remat, accumulate):
    """Three bf16 SGD steps (with remat, or accumulating 2 micro-steps
    into each update) on two alternating batches; on the CPU the plain
    bf16 versions of K7 and K9 run, no kernel."""
    batches = [_batch(50), _batch(60)]
    jm, params, pm = _pair(52, batches[0])
    params0 = {k: v.clone() for k, v in pm.state_dict().items()}
    model_cfg = dict(CFG, **LOSS_CFG)
    jopt = joptim.build_optimizer(from_dict(SGD_CFG),
                                  accumulate_grad_batches=accumulate)
    jtrain, jeval = jharness.streaming_step_fns(
        jm, model_cfg, METRICS_CFG, jopt, mask_self_motion_input=False,
        compute_dtype=jnp.bfloat16, remat=remat)
    state = jopt.init(params)
    key = jax.random.PRNGKey(0)
    jtrain = _compile_exact(jtrain, params, state, _jax_pairs(batches[0]),
                            key)
    popt = optim.build_optimizer(pm.parameters(), SGD_CFG,
                                 accumulate_grad_batches=accumulate)
    ptrain, peval = harness.streaming_step_fns(
        pm, model_cfg, METRICS_CFG, popt, mask_self_motion_input=False,
        compute_dtype=torch.bfloat16, remat=remat)
    launches = (K7.bf16_fwd_launches, K7.fwd_launches,
                K9.bf16_fwd_launches, K9.fwd_launches)
    for step in range(3 * accumulate):
        batch = batches[step % 2]
        params, state, jloss, _ = jtrain(params, state, _jax_pairs(batch),
                                         key)
        ploss, _ = ptrain([(torch.from_numpy(x), None) for x in batch])
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert (K7.bf16_fwd_launches, K7.fwd_launches, K9.bf16_fwd_launches,
            K9.fwd_launches) == launches
    _params_within(pm, params, params0)
    pbatch = [(torch.from_numpy(x), None) for x in batches[0]]
    jeval_loss, _ = jax.jit(jeval)(params, _jax_pairs(batches[0]))
    peval_loss, _ = peval(pbatch)
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


def test_bf16_train_step_on_k8_route_matches_jax(monkeypatch):
    """MRGEN_FUSED_DW=0: the layered blocks on K8's bf16 route on both
    sides (two calls a forward, bf16 W_hh with f32 xw and states), the
    sampler on K9's, each entry's operand dtypes spied on both sides;
    three SGD updates, each from JAX's parameters (the flagship test's
    ``_step_readings``): losses rtol ``LOSS_RTOL``, every parameter within
    ``SYNCED_MOVE_FRAC`` of the largest change JAX's update made to it
    and on average within ``SYNCED_MEAN_FRAC`` of its mean change; the
    port's f32 step, the control, beyond both bounds. On the CPU no kernel
    launches."""
    monkeypatch.setenv("MRGEN_FUSED_DW", "0")
    launches = (K8.bf16_fwd_launches, K8.fwd_launches, K9.bf16_fwd_launches,
                K9.fwd_launches)
    read = _step_readings(52, False, 1, [torch.bfloat16, torch.float32],
                          monkeypatch, cfg=CFG, spies=K8_SPIES, pair=_pair,
                          make_batch=_batch, mask=False)[0]
    assert (K8.bf16_fwd_launches, K8.fwd_launches, K9.bf16_fwd_launches,
            K9.fwd_launches) == launches
    bf16, f32 = read[torch.bfloat16], read[torch.float32]
    assert bf16["loss"] <= LOSS_RTOL, bf16
    assert bf16["move"][0] <= SYNCED_MOVE_FRAC, bf16
    assert bf16["mean"][0] <= SYNCED_MEAN_FRAC, bf16
    assert (f32["move"][0] > SYNCED_MOVE_FRAC
            and f32["mean"][0] > SYNCED_MEAN_FRAC), f32


def test_bf16_step_casts_a_copy_and_leaves_the_model_f32():
    batch = _batch(70)
    pm = LSTMwithSample(CFG, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    opt = optim.build_optimizer(pm.parameters(), SGD_CFG)
    step, _ = harness.streaming_step_fns(
        pm, dict(CFG, **LOSS_CFG), METRICS_CFG, opt, False,
        compute_dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    loss, per_slice = step([(torch.from_numpy(x), None) for x in batch])
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    for name, p in pm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert not torch.equal(p.detach(), before[name]), name
    with pytest.raises(ValueError, match="f32 or bf16"):
        harness.streaming_step_fns(pm, CFG, METRICS_CFG, opt, False,
                                   compute_dtype=torch.float16)


SMALL = [
    "device=cpu", "hidden_size=128", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24",
    "model.sampler_hidden_size=16", "trainer.precision=bf16",
    "callbacks.save_top_k=1",
]


def _last(path):
    return torch.load(path, weights_only=True)


def test_lws_cli_bf16_trains_checkpoints_f32_and_resumes(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["--config", os.path.abspath(YAML), "name=lws",
              f"data_dir={corpus}", "log_dir=log", *SMALL]
    whole = cli.main(common + ["ckpt_path=a", "max_epochs=2"])
    assert whole.epochs_run == 2
    for rec in whole.history:
        assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    last = _last(tmp_path / "a" / "lws" / "last")
    assert all(v.dtype == torch.float32 for v in last["params"].values())

    cli.main(common + ["ckpt_path=b", "max_epochs=1"])
    first = _last(tmp_path / "b" / "lws" / "last")
    assert first["epoch"] == 0 and first["opt"]["state"]
    assert all(v.dtype == torch.float32 for v in first["params"].values())
    torch.save(first, tmp_path / "epoch0")
    ends = []
    for run in ("b", "c"):
        resumed = cli.main(common + [f"ckpt_path={run}", "max_epochs=2",
                                     f"resume_from={tmp_path / 'epoch0'}"])
        assert [r["epoch"] for r in resumed.history] == [1]
        assert resumed.history[0]["lr"] == pytest.approx(0.5e-3)
        ends.append(_last(tmp_path / run / "lws" / "last"))
    assert ends[0]["epoch"] == ends[1]["epoch"] == 1
    for name, value in ends[0]["params"].items():
        assert value.dtype == torch.float32, name
        assert torch.equal(ends[1]["params"][name], value), name
        assert not torch.equal(first["params"][name], value), name

    # scheduled sampling trains its step in f32 whatever the precision
    sched = cli.main(common + ["ckpt_path=c", "max_epochs=1",
                               "model.use_scheduled_sampling=true"])
    assert np.isfinite(sched.history[0]["train_loss"])
