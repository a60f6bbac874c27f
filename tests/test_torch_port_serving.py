"""PyTorch port: ``infer/serving.py ServingEngine`` vs the JAX package.

On ``MF_CFG`` (hidden 32, 2 blocks) with weights crossed by
``state_dict_from_jax``; inputs from numpy seeds, as in
tests/test_serving.py (a lead of 3 frames, 1280-sample hops):
  * a slot against JAX's batch-1 replication of the engine's semantics
    (jitted prime and step, tests/test_serving.py:66-115) over 4 steps:
    f32 rings within 1e-4 abs, bf16 rings (the default of both) within
    5e-2 (the JAX package's bf16 drift bound); and against the port's
    batch-1 ``StreamingSession`` with the same rings: 1e-4;
  * slot isolation: a slot's outputs with another session attached late
    and driven with other data equal those with the other row zeroed,
    bit for bit (rows are independent and the shapes are the same);
  * attach/detach reuse, a full pool, detached rows returned as zeros,
    and the shape validation of ``step``;
  * mha embeddings: the pool carries their rings (a slot against a
    batch-1 session, 1e-4);
  * int8 rings track bf16 within 1e-1 (tests/test_serving.py:257);
  * slots that do not divide a mesh's data axis are refused.
The JAX serving tests are marked slow; these run in tier-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer.generate import (
    _init_metaformer_states as jax_init_states,
)
from multimodalreactiongeneration_tpu.ops import dsp as jdsp
from multimodalreactiongeneration_tpu_torch.infer.generate import (
    _init_metaformer_states,
)
from multimodalreactiongeneration_tpu_torch.infer.serving import (
    ServingEngine,
)
from multimodalreactiongeneration_tpu_torch.infer.streaming import (
    StreamingSession,
)
from multimodalreactiongeneration_tpu_torch.ops import mixer_stack as K1
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)
LEAD = 3
HOP = 1280


@pytest.fixture(scope="module")
def models():
    return paired_models(MF_CFG, 81, np_batch(80))


def _lead(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, LEAD * 8, 81)).astype(np.float32),
            rng.normal(size=(1, LEAD, 18)).astype(np.float32),
            rng.normal(size=(1, LEAD, 18)).astype(np.float32))


def _inputs(seed, steps):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal((steps, HOP))).astype(np.float32),
            rng.normal(size=(steps, 1, 18)).astype(np.float32))


def _session(model, dtype):
    """A batch-1 StreamingSession on rings of ``dtype``."""
    session = StreamingSession(model)
    session.states = _init_metaformer_states(model.cfg, 1, dtype,
                                             kv_layout="shared")
    return session


def _drive(engine, slot, audio, mp, others=None):
    """Step the engine with one slot's inputs; other rows zero, or
    ``others`` (audio, mp) in every other row."""
    outs = []
    for t in range(audio.shape[0]):
        a = np.zeros((engine.slots, engine.hop_samples), np.float32)
        m = np.zeros((engine.slots, 1, 18), np.float32)
        if others is not None:
            a[:], m[:] = others[0][t], others[1][t]
        a[slot], m[slot] = audio[t], mp[t]
        outs.append(engine.step(a, m)[slot])
    return np.stack(outs)


def _jax_replication(jm, params, lead, audio, mp, dtype, fbp, context):
    """tests/test_serving.py's plain batch-1 replication, jitted."""
    prime = jax.jit(lambda p, la, lmp, lms, st: jm.apply(
        p, la, lmp, lms, states=st, use_masks=True))
    step = jax.jit(lambda p, feat, mpf, prev, st: jm.apply(
        p, feat, mpf, prev, states=st, use_masks=False))
    st = jax_init_states(MF_CFG, 1, dtype, kv_layout="shared")
    want = []
    with jax.default_matmul_precision("highest"):
        _, st = prime(params, *[jnp.asarray(x) for x in lead], st)
        prev = jnp.asarray(lead[2][:, -1:])
        tail = np.zeros(context, np.float32)
        for t in range(audio.shape[0]):
            buf = np.concatenate([tail, audio[t]])
            tail = buf[-context:]
            feat = jdsp.logmel_with_power(jnp.asarray(buf), fbp)[None]
            y, st = step(params, feat, jnp.asarray(mp[t])[None], prev, st)
            prev = y
            want.append(np.asarray(y)[0])
    return np.stack(want)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_single_slot_matches_jax_replication(models, dtype, atol):
    jm, params, pm = models
    lead = _lead(0)
    audio, mp = _inputs(1, 4)
    pdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    engine = ServingEngine(pm, slots=2, cache_dtype=pdt)
    assert engine.kv_layout == "shared"
    k1 = K1.launches
    slot = engine.attach(*lead)
    got = _drive(engine, slot, audio, mp)
    assert K1.launches == k1  # CPU tensors: the plain stack
    want = _jax_replication(jm, params, lead, audio, mp, jdt,
                            jdsp.FbankParams(), engine.context_samples)
    assert got.shape == want.shape == (4, 1, 18)
    np.testing.assert_allclose(got, want, atol=atol)

    session = _session(pm, pdt)
    session.prime(*lead)
    alone = np.stack([session.step(audio[t][None], mp[t][None])[0]
                      for t in range(4)])
    np.testing.assert_allclose(got, alone, atol=1e-4)


def test_slot_isolation(models):
    pm = models[2]
    audio_a, mp_a = _inputs(4, 3)
    audio_b, mp_b = _inputs(5, 3)
    engine = ServingEngine(pm, slots=2)
    sa = engine.attach(*_lead(2))
    alone = _drive(engine, sa, audio_a, mp_a)

    engine2 = ServingEngine(pm, slots=2)
    sa2 = engine2.attach(*_lead(2))
    outs = []
    for t in range(3):
        if t == 1:
            engine2.attach(*_lead(3))  # joins late: its ring trails A's
        a = np.stack([audio_b[t]] * 2)
        m = np.stack([mp_b[t]] * 2)
        a[sa2], m[sa2] = audio_a[t], mp_a[t]
        outs.append(engine2.step(a, m)[sa2])
    np.testing.assert_array_equal(np.stack(outs), alone)
    assert engine2._states["shared"][0]["length"].tolist()[1 - sa2] == \
        LEAD * 8 + 2 * 8


def test_attach_detach_reuse(models):
    pm = models[2]
    audio, mp = _inputs(8, 3)
    engine = ServingEngine(pm, slots=1)
    slot = engine.attach(*_lead(6))
    with pytest.raises(RuntimeError, match="all 1 slots"):
        engine.attach(*_lead(7))
    _drive(engine, slot, audio, mp)
    engine.detach(slot)
    with pytest.raises(ValueError, match="not attached"):
        engine.detach(slot)
    assert not engine.active.any()
    slot_b = engine.attach(*_lead(7))
    reused = _drive(engine, slot_b, audio, mp)
    fresh = ServingEngine(pm, slots=1)
    np.testing.assert_array_equal(
        reused, _drive(fresh, fresh.attach(*_lead(7)), audio, mp))
    engine.detach(slot_b)
    out = engine.step(np.ones((1, HOP), np.float32),
                      np.ones((1, 1, 18), np.float32))
    assert out.shape == (1, 1, 18) and (out == 0).all()


def test_step_shape_validation(models):
    engine = ServingEngine(models[2], slots=2)
    with pytest.raises(ValueError, match="need audio"):
        engine.step(np.zeros((2, 7), np.float32),
                    np.zeros((2, 1, 18), np.float32))
    with pytest.raises(ValueError, match="need partner_motion"):
        engine.step(np.zeros((2, HOP), np.float32),
                    np.zeros((2, 18), np.float32))
    with pytest.raises(ValueError, match="at least 1 slot"):
        ServingEngine(models[2], slots=0)


def test_mha_embeddings(models):
    """The pool carries the mha embeddings' rings: a slot equals a
    batch-1 session on the same inputs."""
    cfg = dict(MF_CFG, emb_mixers=["mha", "mha", "mha"], max_context_len=2)
    _, _, pm = paired_models(cfg, 12, np_batch(12))
    lead = _lead(12)
    audio, mp = _inputs(13, 3)
    engine = ServingEngine(pm, slots=2, cache_dtype=torch.float32)
    slot = engine.attach(*lead)
    out = _drive(engine, slot, audio, mp,
                 others=(audio[::-1].copy(), mp[::-1].copy()))
    assert out.shape == (3, 1, 18) and np.isfinite(out).all()
    session = _session(pm, torch.float32)
    session.prime(*lead)
    alone = np.stack([session.step(audio[t][None], mp[t][None])[0]
                      for t in range(3)])
    np.testing.assert_allclose(out, alone, atol=1e-4)


def test_int8_engine_tracks_bf16(models):
    pm = models[2]
    lead = _lead(5)
    audio, mp = _inputs(6, 4)
    eng16 = ServingEngine(pm, slots=2)
    eng8 = ServingEngine(pm, slots=2, cache_dtype=torch.int8)
    assert eng8.kv_layout == "per_block"
    assert eng16.attach(*lead) == eng8.attach(*lead)
    out16 = _drive(eng16, 0, audio, mp)
    out8 = _drive(eng8, 0, audio, mp)
    assert np.isfinite(out8).all()
    np.testing.assert_allclose(out8, out16, atol=1e-1)


def test_mesh_is_refused(models):
    """What a mesh refuses: slots that do not divide its data axis
    (ValueError, as JAX's engine); a mesh of one rank is the one-card
    pool (the mesh pool itself: tests/test_torch_port_serving_mesh.py)."""
    from multimodalreactiongeneration_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="3 slots do not divide over a "
                       "data axis of 2"):
        ServingEngine(models[2], slots=3, mesh=mesh.DataMesh(data=2))
    engine = ServingEngine(models[2], slots=2, mesh=mesh.make_mesh())
    assert engine.local_slots == 2 and engine.owns(0) and engine.owns(1)
