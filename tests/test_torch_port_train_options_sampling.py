"""PyTorch port: the scheduled-sampling training step vs the JAX package.

``train/harness.py scheduled_sampling_masked_step_fn`` (the port's step
on a given mask) against the JAX ``scheduled_sampling_step_fn``, with the
JAX weights moved over by ``state_dict_from_jax`` and JAX's own mask
(``uniform(rng, (L,)) < rate`` of the step's key) computed here and fed to
the port, on CPU tensors (the port's plain recurrences; the JAX side with
its Pallas calls in interpret mode, as its own tests run them):

  * the Metaformer (2 blocks, hidden 32, 2-block encoders, lead 4; the
    rollout on the in-loop per-block layout with f32 rings, as both
    packages pin it) and lstm_with_sampling (the small lws config with a
    2-layer sampler);
  * rates 0 (teacher-forced), 0.5 and 1 over T 12: two steps each, per-step losses rtol 1e-5 and the parameters after them
    atol 1e-5 (``tests/test_torch_port_train.py``'s bounds), with its
    SGD-momentum: AdamW would scale each gradient to about lr in size,
    the key biases' too, whose gradient is zero in exact arithmetic (the
    bias cancels in the softmax), so both packages would move them by lr
    times the sign of their rounding noise;
  * the port's ``scheduled_sampling_step_fn`` draws ``uniform(L) < rate``
    from the generator it is given, and the rollout leaves the model in
    training mode;
  * under gradient the fused rollout (K2, no backward) raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.train import harness, optim
from tests.test_streaming_models import LWS_CFG, MF_CFG
from tests.test_torch_port_weights import flat_params, np_batch, paired_models

torch.set_num_threads(1)
ATOL = 1e-5
LOSS_CFG = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=2.0)
METRICS = dict(use_centroid=True, use_angle=True, delta_order=2)
SGD = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9)
STEPS, T = 2, 12
_JAX_STEPS = {}  # one jitted JAX step per model type, for every rate


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _batch(seed, t):
    """np_batch with 10% of the target frames padded (-100)."""
    data = np_batch(seed, T=t, lead=4)
    rng = np.random.default_rng(seed + 1)
    data[6][rng.random(data[6].shape[:2]) < 0.1] = -100.0
    return data


def _pair(model_type, seed, batch):
    if model_type == "lstmformer":
        cfg = dict(MF_CFG, **LOSS_CFG)
        jm, params, pm = paired_models(cfg, seed, batch)
        return cfg, jm, params, pm
    cfg = dict(LWS_CFG, sampler_num_layers=2, **LOSS_CFG)
    jm = JaxLSTMwithSample(cfg=cfg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in batch[:6]])
    pm = LSTMwithSample(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(flat_params(params)), strict=True)
    return cfg, jm, params, pm


@pytest.mark.parametrize("model_type", ["lstmformer", "lstm_with_sampling"])
@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_scheduled_sampling_step_matches_jax(model_type, rate):
    t = T
    batch = _batch(40, t)
    cfg, jm, params, pm = _pair(model_type, 41, batch)
    jopt = joptim.build_optimizer(from_dict(SGD))
    if model_type not in _JAX_STEPS:
        _JAX_STEPS[model_type] = jax.jit(jharness.scheduled_sampling_step_fn(
            jm, model_type, cfg, METRICS, jopt))
    jstep = _JAX_STEPS[model_type]
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in batch]
    state = jopt.init(params)
    popt = optim.build_optimizer(pm.parameters(), SGD)
    pstep = harness.scheduled_sampling_masked_step_fn(
        pm, model_type, cfg, METRICS, popt)
    pbatch = [(torch.from_numpy(x), None) for x in batch]

    key = jax.random.PRNGKey(3)
    for step in range(STEPS):
        key, sub = jax.random.split(key)
        mask = np.asarray(jax.random.uniform(sub, (t,)) < jnp.float32(rate))
        params, state, jloss, jslices = jstep(params, state, jbatch, sub,
                                              jnp.float32(rate))
        ploss, pslices = pstep(pbatch, torch.from_numpy(mask.copy()))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {step}")
        for name, (s, n) in pslices.items():
            np.testing.assert_allclose(float(s), float(jslices[name][0]),
                                       rtol=1e-4, err_msg=name)
            assert float(n) == float(jslices[name][1])
    assert pm.training
    want = state_dict_from_jax(flat_params(params))
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=ATOL, err_msg=name)


def test_step_draws_its_mask_from_the_generator(monkeypatch):
    """``train_step(batch, generator, rate)`` hands the masked step
    ``torch.rand(L, generator) < rate``."""
    seen = []
    monkeypatch.setattr(
        harness, "scheduled_sampling_masked_step_fn",
        lambda *a: lambda batch, mask: seen.append(mask) or (0.0, {}))
    step = harness.scheduled_sampling_step_fn(None, "lstmformer", {}, {},
                                              None)
    batch = [(torch.zeros(2, 80, 81), None), (torch.zeros(2, 10, 18), None)]
    step(batch, torch.Generator().manual_seed(9), 0.3)
    want = torch.rand(10, generator=torch.Generator().manual_seed(9)) < 0.3
    assert torch.equal(seen[0], want)


def test_fused_rollout_under_gradient_raises():
    batch = [torch.from_numpy(x) for x in np_batch(5, T=4, lead=2)]
    _, _, pm = paired_models(MF_CFG, 6, np_batch(5, T=4, lead=2))
    mask = torch.ones(4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="no backward"):
        G._generate_metaformer(pm, batch, mask, cache_dtype=torch.float32)
    # the public generator runs without gradient and takes it
    assert G.generate_metaformer(pm, batch, mask).shape == (2, 4, 18)
    # the body on the per-block layout records a graph
    y = G._generate_metaformer(pm, batch, mask, cache_dtype=torch.float32,
                               kv_layout="per_block")
    assert y.requires_grad
