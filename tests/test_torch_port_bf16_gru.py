"""PyTorch port: the bf16 mixed-precision training step of the GRU
Metaformer (configs/lstmformer_gru.yaml) and of the flagship on K8's
route (``MRGEN_FUSED_DW=0``) vs the JAX package on the CPU, and their
CLI runs.

The method is tests/test_torch_port_bf16_flagship.py's
(``_step_readings``): the JAX side under ``MRGEN_RNN_IMPL=pallas`` and
``MRGEN_FUSED_ATTN=force`` with the Pallas calls in interpret mode, so
its GRUs take ``gru_recurrence`` (K10), its self-motion LSTMs under
``MRGEN_FUSED_DW=0`` ``lstm_recurrence`` (K8) and its integrators
``rect_attention`` (K5/K6), as the port's do; its step compiled with
``xla_allow_excess_precision`` off; three SGD updates from the same
parameters, the port taking JAX's parameters before each (a bf16 step
is chaotic: a rounding flip on either side moves a bf16 copy by an ulp
and the next steps amplify it). Per update: losses rtol ``LOSS_RTOL``;
the parameters f32; each kernel entry's operand dtypes JAX's (spied on
both sides: every GRU and K8 call in the bf16 mode, bf16 W_hh with f32
xw, biases and states; K5/K6 as the flagship's); every parameter within
``MOVE_FRAC`` of the largest change JAX's update made to it and, on
average, within ``MEAN_FRAC`` of its mean change; the k projections'
biases within ``NOISE_ATOL`` (their gradient is zero in exact
arithmetic). The port's f32 step, the control, must read beyond both
bounds. The bounds are the flagship's; tests/bf16_step_survey.py
(``--model gru``, ``--model flagship_k8``) reads them over 12 model
seeds.

  * The GRU Metaformer (hidden 32, 2 blocks, 2-block GRU encoders, T 24,
    lead 4; on the CPU the plain bf16 K10 runs): the step, plain and with
    ``remat=True``; the eval step (f32) on JAX's final parameters rtol
    1e-5.
  * The flagship at hidden 128 under ``MRGEN_FUSED_DW=0`` (the
    self-motion LSTMs on K8's route; the encoder stacks on K3/K4, which
    the flag does not move): the step.
  * The training CLI with ``trainer.precision=bf16`` on
    configs/lstmformer_gru.yaml trains, writes f32 checkpoints
    (parameters and optimizer state) and resumes from them bit for bit;
    on configs/lstmformer.yaml under ``MRGEN_FUSED_DW=0`` it trains an
    epoch and writes f32 checkpoints.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_gru as jgru
from multimodalreactiongeneration_tpu.ops import pallas_lstm as jlstm
from multimodalreactiongeneration_tpu.ops import pallas_mixer_stack as jstack
from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import attention as patt
from multimodalreactiongeneration_tpu_torch.nn import mixers as pmix
from multimodalreactiongeneration_tpu_torch.ops import gru as K10
from multimodalreactiongeneration_tpu_torch.ops import lstm_recurrence as K8
from multimodalreactiongeneration_tpu_torch.ops import rect_attention as K5
from multimodalreactiongeneration_tpu_torch.train import cli, harness, optim
from tests.fixtures import make_synthetic_corpus
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_bf16_flagship import (
    CFG as FLAGSHIP_CFG,
    LOSS_RTOL,
    MEAN_FRAC,
    MOVE_FRAC,
    NOISE_ATOL,
    _jax_pairs,
    _step_readings,
)
from tests.test_torch_port_train import (
    LOSS_CFG,
    METRICS_CFG,
    SGD_CFG,
    _train_batch,
)
from tests.test_torch_port_weights import flat_params, paired_models

torch.set_num_threads(1)
GRU_CFG = dict(MF_CFG, emb_mixers=["gru", "gru", "gru"])
STEP_SEED = 51
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
# the kernel entries spied on both sides, and the calls of each in one
# forward: the GRU Metaformer's GRUs (two 2-block encoders, a self-motion
# block in each of 2 blocks) and integrators; the flagship's encoder
# stacks, K8 self-motion LSTMs and integrators
GRU_SPIES = {"jax": ((jgru, "gru_recurrence", 0), (jra, "rect_attention", 1)),
             "port": ((K10, "gru_recurrence", 0),
                      (patt, "rect_attention", 1)),
             "calls": [6, 4]}
K8_SPIES = {"jax": ((jstack, "mixer_stack_recurrence", 0),
                    (jlstm, "lstm_recurrence", 0), (jra, "rect_attention", 1)),
            "port": ((pmix, "mixer_stack_recurrence", 0),
                     (K8, "lstm_recurrence", 0), (patt, "rect_attention", 1)),
            "calls": [2, 2, 4]}


@pytest.fixture(autouse=True)
def _kernel_routes(monkeypatch):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _launches():
    return (K10.fwd_launches, K10.bf16_fwd_launches, K8.fwd_launches,
            K8.bf16_fwd_launches, K5.fwd_launches, K5.bf16_fwd_launches)


def _hold(read, control=True):
    bf16 = read[torch.bfloat16]
    assert bf16["loss"] <= LOSS_RTOL, bf16
    assert bf16["move"][0] <= MOVE_FRAC, bf16
    assert bf16["noise"] <= NOISE_ATOL, bf16
    assert bf16["mean"][0] <= MEAN_FRAC, bf16
    if control:
        f32 = read[torch.float32]
        assert f32["move"][0] > MOVE_FRAC and f32["mean"][0] > MEAN_FRAC, f32


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_gru_step_matches_jax(remat, monkeypatch):
    """Three bf16 SGD updates of the GRU Metaformer, each from JAX's
    parameters (with remat too); on the CPU the plain bf16 versions of K10
    and K5/K6 run, no kernel. The plain case also runs the port's f32 step
    as the control the bounds must reject, and the eval step."""
    launches = _launches()
    sides = [torch.bfloat16] + [torch.float32] * (not remat)
    read, params, jeval = _step_readings(
        STEP_SEED, remat, 1, sides, monkeypatch, cfg=GRU_CFG,
        spies=GRU_SPIES)
    assert _launches() == launches
    _hold(read, control=not remat)
    if remat:
        return
    pm = paired_models(GRU_CFG, STEP_SEED, _train_batch(50))[2]
    pm.load_state_dict(state_dict_from_jax(flat_params(params)))
    batch = _train_batch(50)
    jeval_loss, _ = jax.jit(jeval)(params, _jax_pairs(batch))
    peval_loss, _ = harness.streaming_step_fns(
        pm, dict(GRU_CFG, **LOSS_CFG), METRICS_CFG,
        optim.build_optimizer(pm.parameters(), SGD_CFG),
        mask_self_motion_input=True)[1](
            [(torch.from_numpy(x), None) for x in batch])
    np.testing.assert_allclose(float(peval_loss), float(jeval_loss),
                               rtol=1e-5)


def test_bf16_flagship_k8_step_matches_jax(monkeypatch):
    """The flagship's bf16 step under MRGEN_FUSED_DW=0: its self-motion
    LSTMs on K8's bf16 route on both sides."""
    monkeypatch.setenv("MRGEN_FUSED_DW", "0")
    launches = _launches()
    read, _, _ = _step_readings(
        STEP_SEED, False, 1, [torch.bfloat16, torch.float32], monkeypatch,
        cfg=FLAGSHIP_CFG, spies=K8_SPIES)
    assert _launches() == launches
    _hold(read)


# ---- the CLI --------------------------------------------------------------

SMALL = [
    "device=cpu", "bottleneck_size=8", "batch_size=2", "optim_epochs=2",
    "lr=1e-3", "motion.max_len=150", "motion.min_len=50",
    "motion.shift_len=150", "motion.leading_len=24", "model.num_block=1",
    "model.encoder_num_layer=2", "trainer.precision=bf16",
    "callbacks.save_top_k=1",
]


def _last(path):
    return torch.load(path, weights_only=True)


def _all_f32(ckpt):
    tensors = list(ckpt["params"].values()) + [
        v for st in ckpt["opt"]["state"].values() for v in st.values()
        if torch.is_tensor(v) and v.is_floating_point()]
    return tensors and all(v.dtype == torch.float32 for v in tensors)


def test_gru_cli_bf16_trains_checkpoints_f32_and_resumes(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)  # the manifests go under ./data
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    common = ["--config", os.path.abspath(os.path.join(
        CONFIGS, "lstmformer_gru.yaml")), "name=gru", f"data_dir={corpus}",
        "log_dir=log", "hidden_size=32", *SMALL]
    before = _launches()
    cli.main(common + ["ckpt_path=a", "max_epochs=1"])
    first = _last(tmp_path / "a" / "gru" / "last")
    assert first["epoch"] == 0 and first["opt"]["state"]
    assert _all_f32(first)
    assert _launches() == before  # the CPU runs the plain versions
    torch.save(first, tmp_path / "epoch0")
    ends = []
    for run in ("b", "c"):
        resumed = cli.main(common + [f"ckpt_path={run}", "max_epochs=2",
                                     f"resume_from={tmp_path / 'epoch0'}"])
        assert [r["epoch"] for r in resumed.history] == [1]
        assert np.isfinite(resumed.history[0]["train_loss"])
        assert np.isfinite(resumed.history[0]["val_loss"])
        ends.append(_last(tmp_path / run / "gru" / "last"))
    assert ends[0]["epoch"] == ends[1]["epoch"] == 1
    assert _all_f32(ends[0])
    for name, value in ends[0]["params"].items():
        assert torch.equal(ends[1]["params"][name], value), name
        assert not torch.equal(first["params"][name], value), name


def test_flagship_cli_bf16_trains_on_k8_route(tmp_path, monkeypatch):
    """The flagship's bf16 CLI run under MRGEN_FUSED_DW=0 (its
    self-motion LSTMs on K8's route): an epoch, f32 checkpoints."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MRGEN_FUSED_DW", "0")
    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    calls = []
    recurrence = K8.lstm_recurrence

    def spy(*args):
        calls.append(args[1].dtype)
        return recurrence(*args)

    monkeypatch.setattr(K8, "lstm_recurrence", spy)
    run = cli.main(["--config", os.path.abspath(os.path.join(
        CONFIGS, "lstmformer.yaml")), "name=mf", f"data_dir={corpus}",
        "ckpt_path=ck", "log_dir=log", "hidden_size=128", "max_epochs=1",
        *SMALL])
    assert np.isfinite(run.history[0]["train_loss"])
    assert np.isfinite(run.history[0]["val_loss"])
    assert _all_f32(_last(tmp_path / "ck" / "mf" / "last"))
    # the train steps in the bf16 mode, validation in f32
    assert torch.bfloat16 in calls and torch.float32 in calls
