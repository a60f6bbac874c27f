"""PyTorch port: the decode slice as a whole vs the JAX package.

The port's ``generate_metaformer`` on CPU tensors (its fused rollout
then runs the plain ``decode_rollout_reference``, and the encoder stacks
the plain mixer-stack version) and its step-by-step module loop, both
vs JAX ``generate_metaformer(cache_dtype=float32, kv_layout="shared",
fused_rollout=False)`` on the same weights (``state_dict_from_jax``):

  * teacher-forced: atol 2e-5;
  * free-running (full mask), 6 steps only: atol 1e-4;
  * port bf16 caches vs JAX f32, teacher-forced: atol 5e-2 (the JAX
    package's bf16 drift bound);
  * the hoisted encoder pass vs JAX ``encode_others_only``: atol 2e-5.

Masks are made with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer.generate import (
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.ops import (
    decode_rollout as K2,
    mixer_stack as K1,
)
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)
STEPS = 6


@pytest.fixture(scope="module")
def models():
    batch = np_batch(40)
    jm, params, pm = paired_models(MF_CFG, 41, batch)
    return jm, params, pm, batch


def _jax(jm, params, batch, mask):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_generate(
            jm, params, tuple(jnp.asarray(x) for x in batch),
            jnp.asarray(mask), cache_dtype=jnp.float32, kv_layout="shared",
            fused_rollout=False,
        ))


def _port(pm, batch, mask, **kw):
    return G.generate_metaformer(
        pm, [torch.from_numpy(x) for x in batch], torch.from_numpy(mask),
        **kw).numpy()


@pytest.fixture(scope="module")
def jax_outputs(models):
    jm, params, _, batch = models
    return {
        "teacher": _jax(jm, params, batch, np.zeros(STEPS, bool)),
        "full": _jax(jm, params, batch, np.ones(STEPS, bool)),
    }


@pytest.mark.parametrize("fused_rollout", ["auto", False])
@pytest.mark.parametrize("mode,atol", [("teacher", 2e-5), ("full", 1e-4)])
def test_generation_matches_jax(models, jax_outputs, mode, atol,
                                fused_rollout):
    _, _, pm, batch = models
    mask = np.zeros(STEPS, bool) if mode == "teacher" else np.ones(STEPS, bool)
    k1, k2 = K1.launches, K2.launches
    got = _port(pm, batch, mask, cache_dtype=torch.float32,
                fused_rollout=fused_rollout)
    assert (K1.launches, K2.launches) == (k1, k2)  # CPU: plain versions
    want = jax_outputs[mode]
    assert got.shape == want.shape == (2, STEPS, 18)
    np.testing.assert_allclose(got, want, atol=atol)


def test_bf16_caches_track_jax_f32(models, jax_outputs):
    _, _, pm, batch = models
    got = _port(pm, batch, np.zeros(STEPS, bool))  # bf16 default
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_outputs["teacher"], atol=5e-2)


def test_hoisted_encoder_pass_matches_jax(models):
    jm, params, pm, batch = models
    full_a = np.concatenate([batch[3], batch[0]], axis=1)
    full_mp = np.concatenate([batch[4], batch[1]], axis=1)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(params, jnp.asarray(full_a), jnp.asarray(full_mp),
                        None, encode_others_only=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(full_a), torch.from_numpy(full_mp), None,
                 encode_others_only=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_fused_rollout_gate_matches_jax_gate():
    from multimodalreactiongeneration_tpu.infer import generate as JG

    for cfg, dt, ratio, len_a0 in [
        (MF_CFG, "f32", 8, 16), (MF_CFG, "bf16", 8, 96),
        (dict(MF_CFG, interlayer_residual=True), "f32", 8, 16),
        (MF_CFG, "bf16", 8, 100), (dict(MF_CFG, num_layerd=2), "f32", 8, 16),
    ]:
        jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
        pdt = torch.float32 if dt == "f32" else torch.bfloat16
        assert G._fused_rollout_supported(cfg, pdt, ratio, len_a0) == \
            JG._fused_rollout_supported(cfg, jdt, ratio, len_a0)


def test_forced_fused_rollout_outside_contract_raises(models):
    _, _, _, batch = models
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    pm = Metaformer(dict(MF_CFG, interlayer_residual=True), device="cpu")
    with pytest.raises(ValueError, match="fused_rollout"):
        _port(pm, batch, np.ones(STEPS, bool), fused_rollout=True)


def test_decode_is_deterministic_in_any_mode(models, jax_outputs):
    """A freshly built model is in training mode; with dropout above 0
    its mixers refuse to run there. Decode runs in eval mode, as the JAX
    decode is always deterministic, and leaves the model's mode as it
    found it."""
    _, _, pm, batch = models
    from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
        Metaformer,
    )

    drop = Metaformer(dict(MF_CFG, dropout=0.1), device="cpu")
    drop.load_state_dict(pm.state_dict(), strict=True)
    assert drop.training
    got = _port(drop, batch, np.zeros(STEPS, bool), cache_dtype=torch.float32)
    assert drop.training
    np.testing.assert_allclose(got, jax_outputs["teacher"], atol=2e-5)


def test_scheduled_mask_from_torch_generator():
    g = torch.Generator().manual_seed(3)
    m = G.sampling_mask_for(1000, "scheduled", generator=g, rate=0.3)
    assert m.dtype == torch.bool and 0.25 < float(m.float().mean()) < 0.35
    with pytest.raises(ValueError):
        G.sampling_mask_for(4, "scheduled")
