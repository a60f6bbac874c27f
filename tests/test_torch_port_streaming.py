"""PyTorch port: ``infer/streaming.py`` vs the JAX package.

  * ``fbank_stream_geometry`` and ``MotionDeltaStream`` equal JAX's;
  * the streamed fbank (the session's left-context rule, one 1280-sample
    hop at a time) equals the port's offline fbank of the whole signal
    bit for bit on the CPU, and the JAX offline fbank within its own test's
    2e-4 (tests/test_streaming.py);
  * ``StreamingSession`` primed and unprimed against JAX
    ``StreamingSession`` over 5 steps of the same audio and partner
    frames, on ``MF_CFG`` (hidden 32, 2 blocks) with weights crossed by
    ``state_dict_from_jax``: f32 rings (the JAX session's states replaced
    by ``_init_metaformer_states(..., float32)``) within 1e-4 abs; bf16
    rings, the default of both, within 5e-2 (the JAX package's bf16 drift
    bound, tests/test_generate.py);
  * a step of the wrong hop raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer import streaming as JS
from multimodalreactiongeneration_tpu.infer.generate import (
    _init_metaformer_states as jax_init_states,
)
from multimodalreactiongeneration_tpu.ops import dsp as jdsp
from multimodalreactiongeneration_tpu_torch.configs import (
    LSTMFORMER_MODEL_CFG,
)
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.infer import streaming as PS
from multimodalreactiongeneration_tpu_torch.ops import dsp as pdsp
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)
STEPS = 5
LEAD = 3


@pytest.mark.parametrize("cfg", [MF_CFG, LSTMFORMER_MODEL_CFG,
                                 dict(MF_CFG, delta_order=1)])
def test_stream_geometry_matches_jax(cfg):
    got = PS.fbank_stream_geometry(cfg)
    want = JS.fbank_stream_geometry(cfg)
    assert got[1:] == want[1:]
    for field in ("sample_rate", "n_fft", "hop", "n_mels", "delta_order"):
        assert getattr(got[0], field) == getattr(want[0], field)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_motion_delta_stream_matches_jax(order):
    poses = np.random.default_rng(1).normal(size=(10, 6)).astype(np.float32)
    ps, js = PS.MotionDeltaStream(order), JS.MotionDeltaStream(order)
    for pose in poses:
        got, want = ps.push(pose), js.push(pose)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    full = pdsp.delta_stack(torch.from_numpy(poses), order).numpy()
    np.testing.assert_array_equal(got, full[-1])


def test_streamed_fbank_matches_offline():
    rng = np.random.default_rng(0)
    wave = (0.3 * rng.standard_normal(4 * 16000)).astype(np.float32)
    fbp, _, hop_samples, context = PS.fbank_stream_geometry(MF_CFG)
    warmup = context // fbp.hop
    tail = np.zeros(context, np.float32)
    chunks = []
    for i in range(0, len(wave) - hop_samples + 1, hop_samples):
        buf = np.concatenate([tail, wave[i:i + hop_samples]])
        tail = buf[-context:]
        chunks.append(pdsp.logmel_with_power(torch.from_numpy(buf), fbp))
    streamed = torch.cat(chunks).numpy()
    offline = pdsp.logmel_with_power(torch.from_numpy(wave), fbp).numpy()
    # the streamed signal starts with `context` zeros: `warmup` extra rows
    n = min(len(offline), len(streamed) - warmup)
    np.testing.assert_array_equal(streamed[warmup:warmup + n], offline[:n])
    jax_offline = np.asarray(jdsp.logmel_with_power(wave, jdsp.FbankParams()))
    np.testing.assert_allclose(streamed[warmup:warmup + n], jax_offline[:n],
                               atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jm, params, pm = paired_models(MF_CFG, 71, np_batch(70))
    return jm, params, pm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lead = (rng.normal(size=(1, LEAD * 8, 81)).astype(np.float32),
            rng.normal(size=(1, LEAD, 18)).astype(np.float32),
            rng.normal(size=(1, LEAD, 18)).astype(np.float32))
    audio = (0.1 * rng.standard_normal((STEPS, 1, 1280))).astype(np.float32)
    mp = rng.normal(size=(STEPS, 1, 1, 18)).astype(np.float32)
    return lead, audio, mp


@pytest.mark.parametrize("primed", [True, False])
@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_session_matches_jax(models, primed, dtype, atol):
    jm, params, pm = models
    lead, audio, mp = _inputs(72)
    js = JS.StreamingSession(jm, params, batch=1)
    ps = PS.StreamingSession(pm, batch=1)
    if dtype == "f32":
        js.states = jax_init_states(MF_CFG, 1, jnp.float32,
                                    kv_layout=js.kv_layout)
        ps.states = G._init_metaformer_states(MF_CFG, 1, torch.float32,
                                              kv_layout=ps.kv_layout)
    assert ps.kv_layout == js.kv_layout == "shared"
    assert ps.device == torch.device("cpu")
    if primed:
        with jax.default_matmul_precision("highest"):
            js.prime(*lead)
        ps.prime(*lead)
    got, want = [], []
    with jax.default_matmul_precision("highest"):
        for t in range(STEPS):
            want.append(js.step(audio[t], mp[t]))
            got.append(ps.step(audio[t], mp[t]))
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape == (1, STEPS, 18)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol)
    lead_tokens = LEAD * 8 if primed else 0
    assert int(ps.states["shared"][0]["length"]) == lead_tokens + STEPS * 8


def test_wrong_hop_raises(models):
    session = PS.StreamingSession(models[2])
    with pytest.raises(ValueError, match="1280 samples"):
        session.step(np.zeros((1, 100), np.float32),
                     np.zeros((1, 1, 18), np.float32))
