"""PyTorch port: lstm_with_sampling (LSTMwithSample) vs the JAX package.

On CPU tensors (the port's plain recurrences), with the JAX weights moved
over by ``state_dict_from_jax``; the JAX side runs its TPU configuration
(``MRGEN_RNN_IMPL=pallas``, the Pallas calls in interpret mode), so its
sampler, a 2-layer LSTM, takes the stacked wavefront (K9) from 16 steps
on, as the port's does. The JAX tests' small lws config
(tests/test_streaming_models.py) with ``sampler_num_layers=2``:

  * ``LSTMLayerd`` (use_mixing both ways, FFN on), ``LSTMSampler`` and
    ``LSTMwithSample`` (use_mixing both ways): forward with a lead, then
    a step from the carried states: atol 1e-5;
  * ``generate_lws``: teacher-forced, both ``carry_layerd_state`` values,
    atol 1e-5; the full mask over 6 steps, atol 1e-4 (free-running
    rollouts amplify differences step by step); the generation eval's
    loss, rtol 1e-4;
  * ``streaming_step_fns`` with ``mask_self_motion_input=False`` (the
    self motion's -100 padding goes into the model, as in the JAX CLI):
    three SGD steps, per-step losses rtol 1e-5, final parameters atol
    1e-5;
  * the weight bridge, ``build_model``, the configs and the training CLI
    on a synthetic corpus (an epoch with the generation eval, V/T/G and
    ``last`` checkpoints, a resumed epoch).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.infer.generate import (
    generate_lws as jax_generate_lws,
)
from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.nn import lstm_block as jblock
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.train.generation_eval import (
    make_generation_eval as jax_generation_eval,
)
from multimodalreactiongeneration_tpu.utils import config as jconfig
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch import configs
from multimodalreactiongeneration_tpu_torch.infer.generate import generate_lws
from multimodalreactiongeneration_tpu_torch.models import build_model
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import lstm_block
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from multimodalreactiongeneration_tpu_torch.train.generation_eval import (
    make_generation_eval,
)
from tests.fixtures import make_synthetic_corpus
from tests.test_streaming_models import LWS_CFG
from tests.test_torch_port_weights import flat_params, np_batch

torch.set_num_threads(1)
CFG = dict(LWS_CFG, sampler_num_layers=2)
ATOL = 1e-5
STEPS = 6
YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "lstm_with_sampling.yaml")


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _pair(cfg, seed, batch):
    """(jax model, jax params, port model) holding the same weights."""
    jm = JaxLSTMwithSample(cfg=cfg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in batch[:6]])
    pm = LSTMwithSample(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm


def _close(got, want, atol=ATOL):
    """Nested outputs (tensors, tuples, lists) against JAX's."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=atol)


def _torch(xs):
    return [torch.from_numpy(x) for x in xs]


# ---- the modules ------------------------------------------------------------

@pytest.mark.parametrize("use_mixing", [False, True])
def test_lstm_with_sample_matches_jax(use_mixing):
    """Forward with a lead (sampler 32 steps: the stacked route), then 2
    frames from the carried states (sampler 16 steps)."""
    cfg = dict(CFG, use_mixing=use_mixing)
    batch = np_batch(11, T=2, lead=2)
    jm, params, pm = _pair(cfg, 12, batch)
    y, state = jm.apply(params, *[jnp.asarray(x) for x in batch[:6]])
    calls = K9.fwd_launches
    with torch.no_grad():
        py, pstate = pm(*_torch(batch[:6]))
    assert K9.fwd_launches == calls  # CPU: the plain version
    _close(py, y)
    _close(pstate, state)

    nxt = np_batch(13, T=2, lead=0)
    y2, state2 = jm.apply(params, *[jnp.asarray(x) for x in nxt[:3]],
                          state=state)
    with torch.no_grad():
        py2, pstate2 = pm(*_torch(nxt[:3]), state=pstate)
    assert pstate2[0][0].shape == (2, 2, 32)  # sampler (L, B, H)
    _close(py2, y2)
    _close(pstate2, state2)


@pytest.mark.parametrize("use_mixing", [False, True])
def test_lstm_layerd_matches_jax(use_mixing):
    """Two blocks with the FFN on, T 12, then 5 steps from the new
    states (the layerd returns the new states, not its input)."""
    hidden = 16 if use_mixing else 32
    kw = dict(input_size=32, lstm_hidden_size=hidden, affine_hidden_size=32,
              bottleneck_size=8, num_layers=2, num_layers_per_block=1,
              output_size=32, bidirectional=False, use_mixing=use_mixing)
    jmod = jblock.LSTMLayerd(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, 32)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(x))
    y, st = jmod.apply(params, jnp.asarray(x))
    y2, st2 = jmod.apply(params, jnp.asarray(x2), st)

    kw["generator"] = torch.Generator().manual_seed(0)
    pmod = lstm_block.LSTMLayerd(**kw)
    pmod.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    with torch.no_grad():
        py, pst = pmod(torch.from_numpy(x))
        py2, pst2 = pmod(torch.from_numpy(x2), pst)
    _close((py, pst, py2, pst2), (y, st, y2, st2))


def test_lstm_sampler_matches_jax():
    jmod = jblock.LSTMSampler(hidden_size=16, num_layers=3, dropout=0.0,
                              decline_rate=8)
    x = np.random.default_rng(5).standard_normal((3, 24, 16)).astype(
        np.float32)
    params = jmod.init(jax.random.PRNGKey(6), jnp.asarray(x))
    y, st = jmod.apply(params, jnp.asarray(x))
    pmod = lstm_block.LSTMSampler(16, 3, 0.0, 8,
                                  torch.Generator().manual_seed(0))
    pmod.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    with torch.no_grad():
        py, pst = pmod(torch.from_numpy(x))
    assert py.shape == (3, 3, 16)
    _close((py, pst), (y, st))


def test_weight_bridge_build_model_and_refusals(monkeypatch):
    batch = np_batch(20, T=STEPS, lead=2)
    jm = JaxLSTMwithSample(cfg=CFG)
    flat = flat_params(jm.init(jax.random.PRNGKey(0),
                               *[jnp.asarray(x) for x in batch[:6]]))
    sd = state_dict_from_jax(flat)
    pm = build_model("lstm_with_sampling", CFG,
                     generator=torch.Generator().manual_seed(1), device="cpu")
    assert isinstance(pm, LSTMwithSample)
    assert set(sd) == set(pm.state_dict()) and len(sd) == len(flat)
    assert ("layerd_lstm.block_0.lstm_module.lstm_module.weight_hh_l0" in sd
            and "sampling_lstm.sampler.bias_ih_l1" in sd)
    for name, t in pm.state_dict().items():
        assert t.shape == sd[name].shape, name
    assert set(state_dict_from_jax(
        {"a/weight_hh_l0_reverse": np.zeros(3)})) == {"a.weight_hh_l0_reverse"}
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_jax({"params/a/weight_hh_x0": np.zeros(3)})

    with pytest.raises(ValueError, match="model_type"):
        build_model("gpt", CFG, device="cpu")
    bad = _torch(batch)
    with pytest.raises(ValueError, match="rate mismatch"):
        pm(bad[0][:, :-8], *bad[1:6])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSTMwithSample(CFG)


# ---- generation -------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_models():
    batch = np_batch(30, T=STEPS, lead=2)
    batch[2][1, -2:] = -100.0  # padded self-motion frames are zeroed
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MRGEN_RNN_IMPL", "pallas")
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        return (*_pair(CFG, 31, batch), batch)


@pytest.mark.parametrize("mode,carry,atol", [
    ("teacher", True, ATOL), ("teacher", False, ATOL), ("full", True, 1e-4),
])
def test_generate_lws_matches_jax(gen_models, mode, carry, atol):
    jm, params, pm, batch = gen_models
    mask = np.full(STEPS, mode == "full")
    want = jax_generate_lws(jm, params, tuple(jnp.asarray(x) for x in batch),
                            jnp.asarray(mask), carry_layerd_state=carry)
    pm.train()
    got = generate_lws(pm, _torch(batch), torch.from_numpy(mask),
                       carry_layerd_state=carry)
    assert pm.training  # the caller's mode is restored
    assert got.shape == (2, STEPS, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_generation_eval_matches_jax(gen_models):
    jm, params, pm, batch = gen_models
    loss_cfg = dict(CFG, loss_type="huber", huber_delta=1.0)
    data = [(x, np.full(2, x.shape[1])) for x in batch]
    want = jax_generation_eval(jm, "lstm_with_sampling", loss_cfg)(
        params, [data])
    got = make_generation_eval(pm, "lstm_with_sampling", loss_cfg)([data])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---- the training step ------------------------------------------------------

LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS_CFG = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD_CFG = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)


def test_train_step_matches_jax():
    """T 4 + lead 2 (sampler 48 steps); 10% of the target frames and the
    tail of one self-motion stream are padding (-100), the latter fed to
    both models as it is."""
    batch = np_batch(50, T=4, lead=2)
    rng = np.random.default_rng(51)
    batch[6][rng.random(batch[6].shape[:2]) < 0.1] = -100.0
    batch[2][1, -3:] = -100.0
    jm, params, pm = _pair(CFG, 52, batch)
    model_cfg = dict(CFG, **LOSS_CFG)

    jopt = joptim.build_optimizer(from_dict(SGD_CFG))
    jtrain, jeval = jharness.streaming_step_fns(
        jm, model_cfg, METRICS_CFG, jopt, mask_self_motion_input=False)
    jtrain = jax.jit(jtrain)
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in batch]
    state = jopt.init(params)
    popt = optim.build_optimizer(pm.parameters(), SGD_CFG)
    ptrain, peval = harness.streaming_step_fns(
        pm, model_cfg, METRICS_CFG, popt, mask_self_motion_input=False)
    pbatch = [(torch.from_numpy(x), None) for x in batch]

    rng_key = jax.random.PRNGKey(0)
    for step in range(3):
        params, state, jloss, _ = jtrain(params, state, jbatch, rng_key)
        ploss, _ = ptrain(pbatch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
    jeval_loss, _ = jeval(params, jbatch)
    peval_loss, _ = peval(pbatch)
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


# ---- configs and the CLI ----------------------------------------------------

def test_lws_config_dict_is_the_yaml():
    with open(YAML, encoding="utf-8") as f:
        assert configs.LSTM_WITH_SAMPLING == jconfig._yaml_load(f.read())


@pytest.mark.parametrize("overrides", [[], [
    "name=run-02", "data_dir=/tmp/c", "ckpt_path=ck", "log_dir=lg",
    "hidden_size=32", "audio.nmels=40", "model.sampler_num_layers=3",
    "batch_size=12", "x.y=on"]])
def test_lws_load_config_resolves_as_the_jax_loader(overrides):
    got = configs.load_config(YAML, overrides)
    assert got.to_dict() == jconfig.load_config(YAML, overrides).to_dict()
    assert configs.load_config("lstm_with_sampling", overrides) == got
    resolved = configs.load_config("lstm_with_sampling")
    for key, value in configs.LWS_MODEL_CFG.items():
        assert resolved.model[key] == value
    assert configs.LWS_MODEL_CFG["sampler_num_layers"] == 2
    assert configs.LWS_OPTIM_CFG["lr"] == 5e-6
    assert configs.LWS_LOSS_CFG["loss_type"] == "huber"
    assert configs.LWS_METRICS_CFG == configs.LSTMFORMER_METRICS_CFG


SMALL = [
    "device=cpu", "hidden_size=32", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24",
    "model.sampler_hidden_size=16", "trainer.val_check_interval=0.5",
    "callbacks.save_top_k=2",
]


def test_lws_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["--config", YAML, "name=lws",
              f"data_dir={corpus}", "ckpt_path=ck", "log_dir=log", *SMALL]
    result = cli.main(common + ["max_epochs=1"])
    assert result.epochs_run == 1
    rec = result.history[0]
    assert rec["val_checks"] == 2
    for key in ("train_loss", "val_loss", "genrt_loss"):
        assert np.isfinite(rec[key]), key
    names = sorted(os.listdir(tmp_path / "ck" / "lws"))
    assert "last" in names
    for mon in "VTG":
        assert any(n.startswith(f"{mon}0-") for n in names), mon
    with open(tmp_path / "log" / "metrics.jsonl", encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    assert [("val_check" in x) for x in lines] == [True, True, False]
    last = torch.load(tmp_path / "ck" / "lws" / "last", weights_only=True)
    assert "sampling_lstm.sampler.weight_hh_l1" in last["params"]

    resumed = cli.main(common + ["max_epochs=2", "resume_from=ck/lws/last"])
    assert [r["epoch"] for r in resumed.history] == [1]
    assert np.isfinite(resumed.history[0]["train_loss"])
    assert resumed.history[0]["lr"] == pytest.approx(0.5e-3)
    last = torch.load(tmp_path / "ck" / "lws" / "last", weights_only=True)
    assert last["epoch"] == 1 and last["opt"]["state"]
