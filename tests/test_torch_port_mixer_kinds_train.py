"""PyTorch port: the training steps of the Metaformer's other mixer kinds
vs the JAX package, on CPU tensors (the modules, forward, gradients and
generation of the same configurations are in
tests/test_torch_port_mixer_kinds.py, whose ``CFGS`` these are).

  * two SGD-momentum steps of ``streaming_step_fns`` for each of
    ``CFGS`` from the same weights on a padded batch, the JAX
    integrators on the rect-attention kernel's route: losses rtol 1e-5
    (tests/test_torch_port_train.py's), each parameter within 1e-5 of
    its largest magnitude, at least 1e-5 (the MLP main mixer's steps move
    ``feature_embedding_0.bias`` to ~4e2, where 1e-5 is below an f32
    ulp);
  * (a)'s bf16 step at hidden 128: three SGD updates against JAX's bf16
    step, each from JAX's parameters, every multi-layer LSTM on K9's
    bf16 mode on both sides (JAX under ``MRGEN_RNN_IMPL=pallas``,
    interpret mode; the port's plain bf16 version), with the port's f32
    step as the control (``_step_readings`` of
    tests/test_torch_port_bf16_flagship.py and its bounds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_lstm_stacked as jk9
from multimodalreactiongeneration_tpu.ops import pallas_rect_attention as jra
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import attention as patt
from multimodalreactiongeneration_tpu_torch.nn import recurrent
from multimodalreactiongeneration_tpu_torch.ops import lstm_stacked as K9
from multimodalreactiongeneration_tpu_torch.train import harness, optim
from tests.test_torch_port_bf16_flagship import (
    MEAN_FRAC,
    MOVE_FRAC,
    NOISE_ATOL,
    _step_readings,
)
from tests.test_torch_port_mixer_kinds import CFGS
from tests.test_torch_port_train import (
    LOSS_CFG,
    METRICS_CFG,
    SGD_CFG,
    _train_batch,
)
from tests.test_torch_port_weights import flat_params, paired_models

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


@pytest.mark.parametrize("name", list(CFGS))
def test_metaformer_train_step_matches_jax(name, monkeypatch):
    """Two SGD-momentum steps of ``streaming_step_fns`` from the same
    weights on a padded batch; the JAX integrators on the rect-attention
    kernel's route (``MRGEN_FUSED_ATTN=force``), as the port's."""
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    cfg = CFGS[name]
    batch = _train_batch(50)
    jm, params, pm = paired_models(cfg, 51, batch)
    model_cfg = dict(cfg, **LOSS_CFG)
    jopt = joptim.build_optimizer(from_dict(SGD_CFG))
    jtrain = jax.jit(jharness.streaming_step_fns(
        jm, model_cfg, METRICS_CFG, jopt, mask_self_motion_input=True)[0])
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in batch]
    state = jopt.init(params)
    popt = optim.build_optimizer(pm.parameters(), SGD_CFG)
    ptrain = harness.streaming_step_fns(
        pm, model_cfg, METRICS_CFG, popt, mask_self_motion_input=True)[0]
    pbatch = [(torch.from_numpy(x), None) for x in batch]
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        for step in range(2):
            params, state, jloss, _ = jtrain(params, state, jbatch, key)
            ploss, _ = ptrain(pbatch)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=1e-5, err_msg=f"step {step}")
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for pname, value in got.items():
        w = want[pname].numpy()
        np.testing.assert_allclose(
            value.numpy(), w, atol=1e-5 * max(1.0, np.abs(w).max()),
            err_msg=pname)


# the multi-layer LSTMs' kernel entry (K9) and the integrators' on each
# side, and the calls of each in one forward of (a) at 2 blocks with
# 2-block encoders: 2 main embeddings + 4 encoder blocks; 4 integrators
# of 2 inner MHA layers (``num_internal_layer`` sets the integrators'
# depth too, in both packages)
A_SPIES = {
    "jax": ((jk9, "lstm_stacked_recurrence", 0), (jra, "rect_attention", 1)),
    "port": ((recurrent, "lstm_stacked_recurrence", 0),
             (patt, "rect_attention", 1)),
    "calls": [6, 8]}


def test_bf16_step_with_two_inner_layers_matches_jax(monkeypatch):
    """(a) at hidden 128 in bf16: three SGD updates, each from JAX's
    parameters (the flagship's bf16 test and bounds); every multi-layer
    LSTM takes K9's bf16 mode on both sides (plain on the CPU). The
    port's f32 step, the control, lands outside the bounds."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    cfg = dict(CFGS["a2"], hidden_size=128)
    launches = K9.bf16_fwd_launches, K9.layers_bf16_fwd_launches
    read, _, _ = _step_readings(51, False, 1,
                                [torch.bfloat16, torch.float32], monkeypatch,
                                cfg=cfg, spies=A_SPIES)
    assert (K9.bf16_fwd_launches, K9.layers_bf16_fwd_launches) == launches
    bf16, f32 = read[torch.bfloat16], read[torch.float32]
    assert bf16["loss"] <= 2e-3, bf16
    assert bf16["move"][0] <= MOVE_FRAC, bf16
    assert bf16["noise"] <= NOISE_ATOL, bf16
    assert bf16["mean"][0] <= MEAN_FRAC, bf16
    assert f32["move"][0] > MOVE_FRAC and f32["mean"][0] > MEAN_FRAC, f32
