"""PyTorch port: simple_lstm (SimpleLSTM) vs the JAX package.

On CPU tensors, with the JAX weights moved over by
``state_dict_from_jax``; the JAX side runs as ``tests/test_simple_lstm.py``
runs it on the CPU (its recurrences on the scan route, the plain
reference of the kernels the TPU runs; the kernels' own parity is
``tests/test_torch_port_lstm_recurrence.py``). The JAX tests' small config
(``tests/test_simple_lstm.py CFG``: bidirectional 16-wide LSTMs over
32-wide affines, 4 heads, 2 attention layers):

  * ``SimpleLSTM`` forward, ``simple_lstm_loss`` and every parameter's
    gradient through the weight bridge, for both ``all_static`` values:
    atol 1e-5; ``split_and_form`` and ``delta_loss_scaler``;
  * ``windowed_step_fns``: two SGD steps and an eval step with a -100
    filler row (the ``row_mask`` rule): losses rtol 1e-5, parameters atol
    1e-5;
  * ``data/databuild.py DataBuilder`` manifests equal to JAX's on a small
    ``.head`` corpus the test writes, the fingerprint cache reused, and
    ``WindowDataset`` items (fbank rtol 1e-5 / atol 2e-5 as
    ``tests/test_torch_port_data.py``; motion 1e-6);
  * ``sliding_window_generate`` over 8 steps: atol 1e-4;
  * ``build_model`` and the weight bridge with the ``_reverse`` leaves;
  * the training CLI on both simple_lstm yamls: an epoch, the checkpoints,
    a resumed epoch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.data.databuild import (
    DataBuilder as JaxDataBuilder,
)
from multimodalreactiongeneration_tpu.data.dataset import (
    WindowDataset as JaxWindowDataset,
)
from multimodalreactiongeneration_tpu.infer import simple_generate as jgen
from multimodalreactiongeneration_tpu.models import simple_lstm as jsimple
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch import configs
from multimodalreactiongeneration_tpu_torch.data.databuild import DataBuilder
from multimodalreactiongeneration_tpu_torch.data.dataset import (
    WindowBatchLoader,
    WindowDataset,
)
from multimodalreactiongeneration_tpu_torch.infer import simple_generate
from multimodalreactiongeneration_tpu_torch.models import build_model
from multimodalreactiongeneration_tpu_torch.models import simple_lstm
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from tests.fixtures import make_synthetic_corpus_v1
from tests.test_simple_lstm import CFG, METRICS
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
ATOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _batch(seed, b=2, ta=120, tm=15):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, ta, 81), (b, tm, 18), (b, 1, 18))]


def _pair(cfg, seed, batch):
    """(jax model, jax params, port model) holding the same weights."""
    jm = jsimple.SimpleLSTM(cfg=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              *[jnp.asarray(x) for x in batch[:2]])
    pm = simple_lstm.SimpleLSTM(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("all_static", [True, False])
def test_forward_loss_and_grads_match_jax(all_static):
    cfg = dict(CFG, all_static=all_static)
    batch = _batch(1)
    jm, params, pm = _pair(cfg, 2, batch)
    fbank, motion, target = [jnp.asarray(x) for x in batch]

    def loss_fn(p):
        y = jm.apply(p, fbank, motion)
        loss, ys = jsimple.simple_lstm_loss(y, target, motion, cfg, METRICS)
        return loss, (y, ys)

    (loss, (y, ys)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    tb = [torch.from_numpy(x) for x in batch]
    py = pm(tb[0], tb[1])
    ploss, pys = simple_lstm.simple_lstm_loss(py, tb[2], tb[1], cfg, METRICS)
    ploss.backward()
    assert py.shape == (2, 1, 18)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(pys.detach().numpy(), np.asarray(ys),
                               atol=ATOL)
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=1e-5)
    want = state_dict_from_jax(flat_params(grads))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
    assert float(pm.acoustic_embed.weight.grad.abs().sum()) > 0


def test_split_and_form_and_delta_scaler_match_jax():
    x, y = _batch(3, tm=15)[1], _batch(4, tm=1)[1]
    for order in (0, 1, 2):
        got = simple_lstm.split_and_form(torch.from_numpy(x),
                                         torch.from_numpy(y), order, 6)
        want = jsimple.split_and_form(jnp.asarray(x), jnp.asarray(y), order,
                                      6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        simple_lstm.delta_loss_scaler(18, 2, 4.0).numpy(),
        np.asarray(jsimple.delta_loss_scaler(18, 2, 4.0)))
    assert simple_lstm.static_base(METRICS) == 6


SGD_CFG = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)


def test_windowed_step_fns_match_jax():
    """Batch 3, the last target row all -100 (a filler row): two SGD train
    steps and an eval step against the JAX step functions."""
    batch = _batch(5, b=3)
    batch[2][2] = -100.0
    jm, params, pm = _pair(CFG, 6, batch)
    jopt = joptim.build_optimizer(from_dict(SGD_CFG))
    jtrain, jeval = jharness.windowed_step_fns(jm, CFG, METRICS, jopt)
    jtrain = jax.jit(jtrain)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    state = jopt.init(params)
    ptrain, peval = harness.windowed_step_fns(
        pm, CFG, METRICS, optim.build_optimizer(pm.parameters(), SGD_CFG))
    pbatch = tuple(torch.from_numpy(x) for x in batch)
    for step in range(2):
        params, state, jloss, jslices = jtrain(params, state, jbatch,
                                               jax.random.PRNGKey(0))
        ploss, pslices = ptrain(pbatch)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
    for name in jslices:
        np.testing.assert_allclose([float(v) for v in pslices[name]],
                                   [float(v) for v in jslices[name]],
                                   rtol=1e-5, err_msg=name)
    want = state_dict_from_jax(flat_params(params))
    for name, value in pm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)
    jloss, _ = jeval(params, jbatch)
    ploss, _ = peval(pbatch)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    assert harness._batch_frames(batch) == 3


def _data_cfg(corpus, **kw):
    cfg = configs.load_config("simple_lstm",
                              [f"data_dir={corpus}"]).to_dict()
    return dict(cfg["data"], **kw), cfg["audio"]


@pytest.fixture(scope="module")
def corpus_v1(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_v1")
    return make_synthetic_corpus_v1(str(root), n_sessions=1, seconds=12.0)


def _manifests(site):
    out = {}
    for name in sorted(os.listdir(site)):
        with open(os.path.join(site, name), encoding="utf-8") as f:
            out[name] = json.load(f)
    return out


def test_databuild_and_window_dataset_match_jax(corpus_v1, tmp_path):
    data_cfg, audio_cfg = _data_cfg(corpus_v1, sample_stride=8)
    jb = JaxDataBuilder(from_dict(data_cfg), cache_root=str(tmp_path / "j"))
    pb = DataBuilder(data_cfg, cache_root=str(tmp_path / "p"))
    got, want = _manifests(pb.data_site), _manifests(jb.data_site)
    assert got == want and len(got) > 4  # datainfo.json + the windows
    again = DataBuilder(data_cfg, cache_root=str(tmp_path / "p"))
    assert again.data_site == pb.data_site  # the fingerprint cache

    jd = JaxWindowDataset(jb.data_site, from_dict(data_cfg),
                          from_dict(audio_cfg))
    pd = WindowDataset(pb.data_site, data_cfg, audio_cfg)
    assert len(pd) == len(jd) == len(got) - 1
    for i in (0, len(pd) - 1):
        (fb, ctx, tgt), (wfb, wctx, wtgt) = pd[i], jd[i]
        assert fb.shape == (120, 81) and ctx.shape == (15, 18)
        assert tgt.shape == (1, 18)
        np.testing.assert_allclose(fb, np.asarray(wfb), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(ctx, wctx, atol=1e-6)
        np.testing.assert_allclose(tgt, wtgt, atol=1e-6)
    loader = WindowBatchLoader(pd, np.arange(len(pd)), 3, shuffle=True)
    shapes = [tuple(x.shape for x in b) for b in loader]
    assert shapes[0] == ((3, 120, 81), (3, 15, 18), (3, 1, 18))
    assert sum(s[0][0] for s in shapes) == len(pd)


def test_sliding_window_generate_matches_jax():
    rng = np.random.default_rng(7)
    fbank = rng.standard_normal((140, 81)).astype(np.float32)
    ctx = rng.standard_normal((15, 18)).astype(np.float32)
    want_w = jgen.audio_windows(jnp.asarray(fbank), 8, 8, 120)
    got_w = simple_generate.audio_windows(torch.from_numpy(fbank), 8, 8, 120)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    jm, params, pm = _pair(CFG, 8, [got_w.numpy()[:1], ctx[None]])
    want = jax.jit(lambda p, f, c: jgen.sliding_window_generate(
        jm, p, f, c))(params, want_w, jnp.asarray(ctx))
    pm.train()
    got = simple_generate.sliding_window_generate(
        pm, got_w, torch.from_numpy(ctx), device="cpu")
    assert pm.training  # the caller's mode is restored
    assert got.shape == (8, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the deltas are the finite differences of the rolled static channels
    np.testing.assert_allclose(got[1, 6:12], got[1, :6] - got[0, :6],
                               atol=1e-5)


def test_build_model_and_weight_bridge():
    batch = _batch(9)
    jm = jsimple.SimpleLSTM(cfg=CFG)
    flat = flat_params(jm.init(jax.random.PRNGKey(0),
                               *[jnp.asarray(x) for x in batch[:2]]))
    sd = state_dict_from_jax(flat)
    pm = build_model("simple_lstm", CFG,
                     generator=torch.Generator().manual_seed(1), device="cpu")
    assert isinstance(pm, simple_lstm.SimpleLSTM)
    assert set(sd) == set(pm.state_dict()) and len(sd) == len(flat)
    for name in ("acoustic_lstm.block_1.lstm_module.lstm_module."
                 "weight_hh_l0_reverse",
                 "decoder_lstm.block_0.lstm_module.mixer.weight",
                 "multimodal_att.att_1.k_proj_weight",
                 "multimodal_att.norm_0.weight"):
        assert name in sd, name
    for name, t in pm.state_dict().items():
        assert t.shape == sd[name].shape, name
        if float(sd[name].std()) > 0:  # drawn from the same family
            ratio = float(t.std()) / float(sd[name].std())
            assert 0.6 < ratio < 1.6, (name, ratio)
    assert len(configs.SIMPLE_LSTM_MODEL_CFG) == 41


SMALL = [
    "device=cpu", "hidden_size=32", "lstm_size=16", "bottleneck_size=8",
    "batch_size=4", "optim_epochs=2", "lr=1e-3", "data.sample_stride=8",
    "model.att_heads=4", "model.acostic_num_layers=1",
    "model.motion_num_layers=1", "model.decoder_num_layers=1",
    "model.decoder_mapping_size=16", "exp.train_rate=0.5",
    "exp.valid_rate=0.25", "callbacks.save_top_k=1",
]


@pytest.mark.parametrize("yaml", ["simple_lstm.yaml", "simple_lstm_best.yaml"])
def test_cli_trains_checkpoints_and_resumes(corpus_v1, tmp_path, monkeypatch,
                                            yaml):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    common = ["--config", os.path.join(ROOT, "configs", yaml), "name=simple",
              f"data_dir={corpus_v1}", "ckpt_path=ck", "log_dir=log", *SMALL]
    result = cli.main(common + ["max_epochs=1"])
    assert result.epochs_run == 1
    rec = result.history[0]
    assert rec["val_checks"] == 1  # no len: the epoch-end check only
    assert "genrt_loss" not in rec  # no generation eval for simple_lstm
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(rec[key]), key
    assert rec["train_frames"] > 0
    names = sorted(os.listdir(tmp_path / "ck" / "simple"))
    assert "last" in names and any(n.startswith("V0-") for n in names)
    assert not any(n[0] in "TG" for n in names)
    last = torch.load(tmp_path / "ck" / "simple" / "last", weights_only=True)
    assert ("acoustic_lstm.block_0.lstm_module.lstm_module."
            "weight_ih_l0_reverse") in last["params"]

    resumed = cli.main(common + ["max_epochs=2",
                                 "resume_from=ck/simple/last"])
    assert [r["epoch"] for r in resumed.history] == [1]
    assert np.isfinite(resumed.history[0]["train_loss"])
    assert resumed.history[0]["lr"] == pytest.approx(0.5e-3)
    last = torch.load(tmp_path / "ck" / "simple" / "last", weights_only=True)
    assert last["epoch"] == 1 and last["opt"]["state"]
