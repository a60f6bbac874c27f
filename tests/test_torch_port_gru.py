"""PyTorch port: the GRU-embedding Metaformer (configs/lstmformer_gru.yaml)
vs the JAX package, on CPU tensors.

  * the port's plain ``gru_recurrence`` (what CPU tensors run) vs the JAX
    ``ops/pallas_gru.py gru_recurrence`` with its Pallas calls in
    interpret mode (patched as tests/test_pallas_lstm.py runs them):
    forward atol 1e-5, the four input gradients under random cotangents
    atol 2e-4 (the JAX test's own bounds);
  * ``TorchGRU`` vs the JAX ``TorchGRU`` on its scan path and on its
    Pallas path (``MRGEN_RNN_IMPL=pallas``, interpret mode), below and
    from 16 steps on, with a given state and with two layers: atol 1e-5;
    the port's dispatch (the recurrence from 16 steps on, the plain loop
    below);
  * the GRU Metaformer (the JAX tests' small config, hidden 32, 2 blocks,
    2-block encoders, with ``emb_mixers`` three GRUs): the weight bridge
    with ``load_state_dict(strict=True)``, the forward (atol 2e-5) and
    gradients to every parameter, the hoisted encoder pass and a
    teacher-forced ``generate_metaformer`` on its step-by-step branch vs
    JAX (atol 2e-5; ``fused_rollout=True`` raises), the generation eval
    (rtol 1e-4);
  * three SGD-momentum steps of ``streaming_step_fns`` vs the JAX
    ``streaming_step_fns`` (per-step losses rtol 1e-5, final parameters
    atol 1e-5, as tests/test_torch_port_train.py);
  * ``configs.LSTMFORMER_GRU`` is the yaml, resolves as the JAX loader,
    and the training CLI with ``--config configs/lstmformer_gru.yaml
    device=cpu`` trains an epoch with the generation eval and resumes.

The CUDA kernels (K10) are held to the plain version on the card in
tests/test_torch_port_kernels.py.
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
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu.nn.recurrent import (
    TorchGRU as JaxTorchGRU,
)
from multimodalreactiongeneration_tpu.ops import pallas_gru
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.train.generation_eval import (
    make_generation_eval as jax_generation_eval,
)
from multimodalreactiongeneration_tpu.utils import config as jconfig
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch import configs
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import mixers, recurrent
from multimodalreactiongeneration_tpu_torch.ops import gru as K10
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from multimodalreactiongeneration_tpu_torch.train.generation_eval import (
    make_generation_eval,
)
from tests.fixtures import make_synthetic_corpus
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import flat_params, np_batch, paired_models

torch.set_num_threads(1)
GRU_CFG = dict(MF_CFG, emb_mixers=["gru", "gru", "gru"])
YAML = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "lstmformer_gru.yaml")
STEPS = 6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# ---- the recurrence ---------------------------------------------------------

def _inputs(seed, b, t, h):
    rng = np.random.default_rng(seed)
    args = [(s * rng.standard_normal(x)).astype(np.float32) for x, s in (
        ((b, t, 3 * h), 0.5), ((h, 3 * h), 0.2), ((3 * h,), 0.1),
        ((b, h), 0.1))]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, h))]
    return args, cots


@pytest.mark.parametrize("t", [16, 37])
def test_plain_gru_recurrence_matches_jax(t):
    args, cots = _inputs(t, 4, t, 32)
    jargs = [jnp.asarray(a) for a in args]

    def loss(*a):
        ys, hn = pallas_gru.gru_recurrence(*a)
        return jnp.sum(ys * cots[0]) + jnp.sum(hn * cots[1])

    ys, hn = pallas_gru.gru_recurrence(*jargs)
    want_grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = K10.fwd_launches, K10.bwd_launches
    pys, phn = K10.gru_recurrence(*leaves)
    grads = torch.autograd.grad((pys, phn), leaves,
                                [torch.from_numpy(c) for c in cots])
    assert (K10.fwd_launches, K10.bwd_launches) == before  # CPU: plain
    for got, want in ((pys, ys), (phn, hn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    for got, want, name in zip(grads, want_grads,
                               ("dxw", "dw_hh_t", "db_hh", "dh0")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   err_msg=name)
    ref = K10.gru_backward_reference([torch.from_numpy(a) for a in args],
                                     *[torch.from_numpy(c) for c in cots])
    for got, want in zip(ref, grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("t", [12, 20])
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_torchgru_matches_jax_module(monkeypatch, impl, t, layers):
    """The JAX module on its scan path, or its Pallas path (from 16 steps
    on; below, it too runs the scan), from a given state."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", impl)
    b, din, h = 3, 24, 32
    rng = np.random.default_rng(t + layers)
    x = (0.5 * rng.standard_normal((b, t, din))).astype(np.float32)
    hx = (0.3 * rng.standard_normal((layers, b, h))).astype(np.float32)
    mod = JaxTorchGRU(input_size=din, hidden_size=h, num_layers=layers)
    params = mod.init(jax.random.PRNGKey(t), jnp.asarray(x))
    ys, hn = mod.apply(params, jnp.asarray(x), jnp.asarray(hx))

    port = recurrent.TorchGRU(din, h, torch.Generator().manual_seed(0),
                              num_layers=layers)
    port.load_state_dict(state_dict_from_jax(flat_params(params)),
                         strict=True)
    with torch.no_grad():
        pys, phn = port(torch.from_numpy(x), torch.from_numpy(hx))
    assert phn.shape == (layers, b, h)
    np.testing.assert_allclose(pys.numpy(), np.asarray(ys), atol=1e-5)
    np.testing.assert_allclose(phn.numpy(), np.asarray(hn), atol=1e-5)


@pytest.mark.parametrize("t,routed", [(16, True), (15, False)])
def test_torchgru_dispatch_on_cpu(monkeypatch, t, routed):
    calls = []
    recurrence = K10.gru_recurrence

    def spy(*args):
        calls.append(args[0].shape)
        return recurrence(*args)

    monkeypatch.setattr(K10, "gru_recurrence", spy)
    port = recurrent.TorchGRU(18, 16, torch.Generator().manual_seed(1))
    x = torch.randn(2, t, 18, generator=torch.Generator().manual_seed(2))
    ys, hn = port(x)
    assert len(calls) == int(routed)
    want, wh = K10.gru_recurrence_reference(
        x @ port.weight_ih_l0.T + port.bias_ih_l0, port.weight_hh_l0.T,
        port.bias_hh_l0, torch.zeros(2, 16))
    torch.testing.assert_close(ys, want)
    torch.testing.assert_close(hn[0], wh)


def test_gru_refusals():
    """What the GRU route refuses, and what it no longer does: a
    bidirectional GRU and 'mlp' mixers build and run (held to JAX in
    tests/test_torch_port_mixer_kinds.py)."""
    gen = torch.Generator().manual_seed(0)
    y, hn = recurrent.TorchGRU(8, 8, gen, bidirectional=True)(
        torch.ones(1, 4, 8))
    assert y.shape == (1, 4, 16) and hn.shape == (2, 1, 8)
    gru = recurrent.TorchGRU(8, 8, gen, num_layers=2, dropout=0.1)
    x = torch.ones(1, 4, 8)
    # dropout between layers in training draws its masks only inside
    # dropout_rng, and then drops some of the first layer's outputs
    with pytest.raises(RuntimeError, match="dropout_rng"):
        gru(x)
    from multimodalreactiongeneration_tpu_torch.nn.basic import dropout_rng
    with dropout_rng(0):
        dropped = gru(x)[0]
    gru.eval()
    assert gru(x)[0].shape == dropped.shape == (1, 4, 8)
    assert not torch.equal(gru(x)[0], dropped)
    # the CUDA route raises for the hidden sizes the kernels do not take
    # (above 256; the others run padded), and only from 16 steps on
    with pytest.raises(NotImplementedError, match="K10"):
        recurrent.use_gru_kernel("cuda", 16, 384)
    assert recurrent.use_gru_kernel("cuda", 16, 32)
    assert not recurrent.use_gru_kernel("cuda", 15, 384)
    assert recurrent.use_gru_kernel("cpu", 16, 32)
    with pytest.raises(ValueError, match="no kernel"):
        K10.gru_forward([torch.zeros(1, 2, 12), torch.zeros(4, 12),
                         torch.zeros(12), torch.zeros(1, 4)], False)
    assert isinstance(mixers.build_mixer_layerd("mlp", {"hidden_size": 8},
                                                gen), mixers.MLPMixerLayerd)
    layerd = mixers.build_mixer_layerd(
        "gru", dict(hidden_size=8, num_layerd=2, residual=True,
                    residual_layer_norm=True), gen)
    assert isinstance(layerd.block_1.mixer, recurrent.TorchGRU)
    y, states = layerd(torch.zeros(2, 20, 8))
    assert y.shape == (2, 20, 8) and [s.shape for s in states] == [
        (1, 2, 8), (1, 2, 8)]


# ---- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def gru_models():
    batch = np_batch(40, T=STEPS, lead=2)
    return (*paired_models(GRU_CFG, 41, batch), batch)


def test_weight_bridge_loads_a_jax_gru_tree(gru_models):
    flat = flat_params(gru_models[1])
    sd = state_dict_from_jax(flat)
    pm = Metaformer(GRU_CFG, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    assert set(sd) == set(pm.state_dict()) and len(sd) == len(flat)
    for name, t in pm.state_dict().items():
        assert t.shape == sd[name].shape, name
    pm.load_state_dict(sd, strict=True)
    w = flat["params/metaformer/block_0/emb_1/block_1/mixer/weight_hh_l0"]
    assert w.shape == (3 * 32, 32)
    np.testing.assert_array_equal(
        pm.metaformer.block_0.emb_1.block_1.mixer.weight_hh_l0.detach()
        .numpy(), w)


def test_gru_metaformer_forward_matches_jax(gru_models):
    """T 24 + lead 4: the audio encoder runs 224 steps, the motion
    streams 28, all from 16 steps on (the recurrence's route)."""
    jm, params, pm, _ = gru_models
    batch = np_batch(42, T=24, lead=4)
    y, states = jm.apply(params, *[jnp.asarray(x) for x in batch[:6]])
    calls = K10.fwd_launches
    with torch.no_grad():
        py, pstates = pm(*[torch.from_numpy(x) for x in batch[:6]])
    assert K10.fwd_launches == calls  # CPU: the plain version
    np.testing.assert_allclose(py.numpy(), np.asarray(y), atol=2e-5)
    for ps, js in zip(pstates, states):
        for p, j in zip(ps["emb"], js["emb"]):
            for pb, jb in zip(p, j):  # per block: h (1, B, H)
                np.testing.assert_allclose(pb.numpy(), np.asarray(jb),
                                           atol=2e-5)


def test_gru_metaformer_trains_every_parameter():
    pm = Metaformer(GRU_CFG, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    batch = [torch.from_numpy(x) for x in np_batch(60, T=24, lead=4)]
    y, _ = pm(*batch[:6])
    y[:, 4:].square().mean().backward()
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        if ".mixer.weight" in name:
            assert float(p.grad.abs().max()) > 0, name


def test_gru_generation_matches_jax(gru_models):
    """Teacher-forced, f32 caches: the hoisted encoder pass, the warmup
    and the step-by-step rollout (the fused rollout's gate needs an LSTM
    main modality, in both packages)."""
    jm, params, pm, batch = gru_models
    mask = np.zeros(STEPS, bool)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_generate(
            jm, params, tuple(jnp.asarray(x) for x in batch),
            jnp.asarray(mask), cache_dtype=jnp.float32, kv_layout="shared"))
    assert not G._fused_rollout_supported(GRU_CFG, torch.float32, 8, 16)
    data = [torch.from_numpy(x) for x in batch]
    got = G.generate_metaformer(pm, data, torch.from_numpy(mask),
                                cache_dtype=torch.float32)
    assert got.shape == want.shape == (2, STEPS, 18)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    with pytest.raises(ValueError, match="fused_rollout"):
        G.generate_metaformer(pm, data, torch.from_numpy(mask),
                              fused_rollout=True)


def test_gru_generation_eval_matches_jax(gru_models):
    jm, params, pm, batch = gru_models
    loss_cfg = dict(GRU_CFG, loss_type="huber", huber_delta=1.0)
    data = [(x, np.full(2, x.shape[1])) for x in batch]
    want = jax_generation_eval(jm, "lstmformer", loss_cfg)(params, [data])
    got = make_generation_eval(pm, "lstmformer", loss_cfg)([data])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---- the training step --------------------------------------------------------

LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS_CFG = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD_CFG = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)


def test_gru_train_step_matches_jax(monkeypatch):
    """T 24, lead 4; 10% of the target frames and the tail of one self-
    motion stream are padding (-100). The JAX side runs its GRUs on the
    Pallas path (interpret mode), as on its TPU, and its integrators on
    its plain attention (tests/test_torch_port_train.py holds the port to
    the JAX rect-attention kernel's route too)."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "0")
    batch = np_batch(50, T=24, lead=4)
    rng = np.random.default_rng(51)
    batch[6][rng.random(batch[6].shape[:2]) < 0.1] = -100.0
    batch[2][1, -3:] = -100.0
    jm, params, pm = paired_models(GRU_CFG, 52, batch)
    model_cfg = dict(GRU_CFG, **LOSS_CFG)

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

    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        for step in range(3):
            params, state, jloss, _ = jtrain(params, state, jbatch, key)
            ploss, _ = ptrain(pbatch)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=1e-5, err_msg=f"step {step}")
        jeval_loss, _ = jeval(params, jbatch)
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    peval_loss, _ = peval(pbatch)
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


# ---- configs and the CLI ------------------------------------------------------

def test_gru_config_dict_is_the_yaml():
    with open(YAML, encoding="utf-8") as f:
        assert configs.LSTMFORMER_GRU == jconfig._yaml_load(f.read())
    assert configs.LSTMFORMER_GRU["model"]["emb_mixers"] == ["gru"] * 3
    assert configs.LSTMFORMER["model"]["emb_mixers"] == ["lstm"] * 3


@pytest.mark.parametrize("overrides", [[], [
    "name=run-03", "data_dir=/tmp/c", "ckpt_path=ck", "log_dir=lg",
    "hidden_size=32", "model.num_block=2", "x.y=on"]])
def test_gru_load_config_resolves_as_the_jax_loader(overrides):
    got = configs.load_config(YAML, overrides)
    assert got.to_dict() == jconfig.load_config(YAML, overrides).to_dict()
    assert configs.load_config("lstmformer_gru", overrides) == got
    resolved = configs.load_config("lstmformer_gru")
    for key, value in configs.LSTMFORMER_GRU_MODEL_CFG.items():
        assert resolved.model[key] == value
    assert configs.LSTMFORMER_GRU_MODEL_CFG == dict(
        configs.LSTMFORMER_MODEL_CFG, emb_mixers=["gru"] * 3)


SMALL = [
    "device=cpu", "hidden_size=32", "bottleneck_size=8", "batch_size=2",
    "optim_epochs=2", "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24", "model.num_block=1",
    "model.encoder_num_layer=2", "trainer.val_check_interval=0.5",
    "callbacks.save_top_k=2",
]


def test_gru_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["--config", YAML, "name=gru",
              f"data_dir={corpus}", "ckpt_path=ck", "log_dir=log", *SMALL]
    result = cli.main(common + ["max_epochs=1"])
    assert result.epochs_run == 1
    rec = result.history[0]
    assert rec["val_checks"] == 2
    for key in ("train_loss", "val_loss", "genrt_loss"):
        assert np.isfinite(rec[key]), key
    names = sorted(os.listdir(tmp_path / "ck" / "gru"))
    assert "last" in names
    for mon in "VTG":
        assert any(n.startswith(f"{mon}0-") for n in names), mon
    with open(tmp_path / "log" / "metrics.jsonl", encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    assert [("val_check" in x) for x in lines] == [True, True, False]
    last = torch.load(tmp_path / "ck" / "gru" / "last", weights_only=True)
    w = last["params"]["metaformer.block_0.emb_0.block_0.mixer.weight_hh_l0"]
    assert w.shape == (3 * 32, 32)  # a GRU's three gates

    resumed = cli.main(common + ["max_epochs=2", "resume_from=ck/gru/last"])
    assert [r["epoch"] for r in resumed.history] == [1]
    assert np.isfinite(resumed.history[0]["train_loss"])
    assert resumed.history[0]["lr"] == pytest.approx(0.5e-3)
    last = torch.load(tmp_path / "ck" / "gru" / "last", weights_only=True)
    assert last["epoch"] == 1 and last["opt"]["state"]
