"""PyTorch port: the KV rings and the decode layouts vs the JAX package.

Cache level, against JAX ``infer/cache.py`` on the same numpy inputs:
``raw_cache_extend`` and ``cache_extend`` at f32 and int8, through a
primed chunk with its causal ``chunk_mask`` and a ring wrap: buffers,
masks and lengths equal, int8 codes and scales equal; and a (B,) tensor
``length`` against a per-row loop of JAX batch-1 extends, equal.

Decode, on ``tests/test_streaming_models.py``'s ``MF_CFG`` (hidden 32, 2
blocks) with weights crossed by ``state_dict_from_jax``, teacher-forced
(every step's input is the ground truth, so steps do not feed their
errors forward) at f32 and matmul precision "highest" on the JAX side:
  * per-block, in-loop shared and hoisted shared vs JAX
    ``generate_metaformer`` with the same arguments: 1e-4 abs;
  * the port's layouts against each other, with and without a ring
    wrap: 1e-4 (JAX holds its own at 1e-5, tests/test_generate.py);
  * an mha-embedding model and a ``repeat_with_encoder`` model: 1e-4;
  * bf16 rings vs JAX f32: 5e-2, int8 vs JAX f32 and vs bf16: 1e-1 (the
    bounds of tests/test_generate.py);
  * the refusals of ``hoist_encoders=True``, ``fused_rollout=True`` off
    the hoisted path and ``_init_metaformer_states``, as JAX refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer import cache as JC
from multimodalreactiongeneration_tpu.infer.generate import (
    _init_metaformer_states as jax_init_states,
    generate_metaformer as jax_generate,
)
from multimodalreactiongeneration_tpu.ops.masks import (
    rectangular_causal_mask,
)
from multimodalreactiongeneration_tpu_torch.infer import cache as PC
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from multimodalreactiongeneration_tpu_torch.ops import (
    decode_rollout as K2,
    mixer_stack as K1,
)
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)
STEPS = 6
TEACHER = np.zeros(STEPS, bool)


# ---------------------------------------------------------------- rings


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      and x.dtype == torch.bfloat16 else x)


def _same_ring(port, jax_ring):
    assert set(port) == set(jax_ring)
    assert int(port["length"]) == int(jax_ring["length"])
    for k in port:
        if k != "length":
            np.testing.assert_array_equal(_np(port[k]), np.asarray(
                jax_ring[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_cache_extend_matches_jax_through_prime_and_wrap(dtype):
    """Prime 3 tokens under their causal mask into a capacity-5 ring, then
    4 single tokens (the ring wraps): every step's rings, the dequantized
    views and the masks equal JAX's."""
    rng = np.random.default_rng(0)
    jdt, pdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.int8, torch.int8))
    jc = JC.cache_init(2, 5, 4, dtype=jdt)
    pc = PC.cache_init(2, 5, 4, dtype=pdt)
    jr = JC.raw_cache_init(2, 5, 4)
    pr = PC.raw_cache_init(2, 5, 4)
    for n in (3, 1, 1, 1, 1):
        k, v = (rng.standard_normal((2, n, 4)).astype(np.float32)
                for _ in range(2))
        cm = np.array(rectangular_causal_mask(n, n)) if n > 1 else None
        jc, jk, jv, jm = JC.cache_extend(
            jc, jnp.asarray(k), jnp.asarray(v),
            None if cm is None else jnp.asarray(cm))
        pc, pk, pv, pm = PC.cache_extend(
            pc, torch.from_numpy(k), torch.from_numpy(v),
            None if cm is None else torch.from_numpy(cm))
        _same_ring(pc, jc)
        np.testing.assert_array_equal(_np(pk), np.asarray(jk, np.float32))
        np.testing.assert_array_equal(_np(pv), np.asarray(jv, np.float32))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        jr, jx, jrm = JC.raw_cache_extend(
            jr, jnp.asarray(k), None if cm is None else jnp.asarray(cm))
        pr, px, prm = PC.raw_cache_extend(
            pr, torch.from_numpy(k),
            None if cm is None else torch.from_numpy(cm))
        _same_ring(pr, jr)
        np.testing.assert_array_equal(prm.numpy(), np.asarray(jrm))
    if dtype == "int8":
        assert pc["k"].dtype == torch.int8 and pc["k_scale"].dtype == \
            torch.float32 and pk.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_per_row_lengths_match_batch1_extends(dtype):
    """A (B,) tensor length: each row writes slot length[b] % C and masks
    its own unwritten slots, as a per-row loop of JAX batch-1 extends
    does (what vmap gives the JAX serving pool)."""
    rng = np.random.default_rng(1)
    jdt, pdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.int8, torch.int8))
    starts = (0, 3, 7)  # tokens already in each row's capacity-5 ring
    rows_j = [JC.cache_init(1, 5, 4, dtype=jdt) for _ in starts]
    raws_j = [JC.raw_cache_init(1, 5, 4) for _ in starts]
    pc = PC.cache_init(3, 5, 4, dtype=pdt)
    pr = PC.raw_cache_init(3, 5, 4)
    for b, n0 in enumerate(starts):
        for _ in range(n0):
            x = jnp.asarray(rng.standard_normal((1, 1, 4)), jnp.float32)
            rows_j[b] = JC.cache_extend(rows_j[b], x, 2 * x)[0]
            raws_j[b] = JC.raw_cache_extend(raws_j[b], x)[0]
        for k in pc:
            if k != "length":
                pc[k][b] = torch.from_numpy(np.array(rows_j[b][k][0]))
        pr["x"][b] = torch.from_numpy(np.array(raws_j[b]["x"][0]))
    pc["length"] = torch.tensor(starts)
    pr["length"] = torch.tensor(starts)
    for _ in range(3):
        x = rng.standard_normal((3, 1, 4)).astype(np.float32)
        pc, pk, _, pm = PC.cache_extend(pc, torch.from_numpy(x),
                                        torch.from_numpy(2 * x))
        pr, _, prm = PC.raw_cache_extend(pr, torch.from_numpy(x))
        assert pm.shape == prm.shape == (3, 1, 5)
        for b in range(3):
            xb = jnp.asarray(x[b:b + 1])
            rows_j[b], jk, _, jm = JC.cache_extend(rows_j[b], xb, 2 * xb)
            raws_j[b], _, jrm = JC.raw_cache_extend(raws_j[b], xb)
            assert int(pc["length"][b]) == int(rows_j[b]["length"])
            for k in pc:
                if k != "length":
                    np.testing.assert_array_equal(
                        _np(pc[k][b]), np.asarray(rows_j[b][k][0]))
            np.testing.assert_array_equal(_np(pk[b]),
                                          np.asarray(jk[0], np.float32))
            np.testing.assert_array_equal(pm[b].numpy(), np.asarray(jm))
            np.testing.assert_array_equal(pr["x"][b].numpy(),
                                          np.asarray(raws_j[b]["x"][0]))
            np.testing.assert_array_equal(prm[b].numpy(), np.asarray(jrm))


def test_overlong_chunk_raises():
    with pytest.raises(ValueError, match="capacity-2"):
        PC.cache_extend(PC.cache_init(1, 2, 4), torch.zeros(1, 3, 4),
                        torch.zeros(1, 3, 4))
    with pytest.raises(ValueError, match="capacity-2"):
        PC.raw_cache_extend(PC.raw_cache_init(1, 2, 4), torch.zeros(1, 3, 4))


# ---------------------------------------------------------------- decode


def _cfg(name):
    return {
        "mf": dict(MF_CFG, max_context_len=100),
        "wrap": dict(MF_CFG, max_context_len=0.25),  # audio 25, motion 3
        "mha": dict(MF_CFG, max_context_len=100,
                    emb_mixers=["mha", "mha", "mha"], encoder_num_layer=1),
        "repeat": dict(MF_CFG, max_context_len=100, repeat_with_encoder=True),
    }[name]


_MODELS = {}


def _models(name):
    """(jax model, params, port model, batch), built once per config."""
    if name not in _MODELS:
        batch = np_batch(60)
        _MODELS[name] = (*paired_models(_cfg(name), 61, batch), batch)
    return _MODELS[name]


def _jax(name, **kw):
    jm, params, _, batch = _models(name)
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_generate(
            jm, params, tuple(jnp.asarray(x) for x in batch),
            jnp.asarray(TEACHER), fused_rollout=False, unroll=1, **kw))


def _port(name, **kw):
    _, _, pm, batch = _models(name)
    return G.generate_metaformer(
        pm, [torch.from_numpy(x) for x in batch], torch.from_numpy(TEACHER),
        **kw).numpy()


F32 = dict(cache_dtype=torch.float32)
LAYOUTS = {
    "per_block": dict(kv_layout="per_block"),
    "in_loop": dict(kv_layout="shared", hoist_encoders=False),
    "hoisted": dict(kv_layout="shared", hoist_encoders=True),
}


@pytest.mark.parametrize("name,layout", [
    ("mf", "per_block"), ("mf", "in_loop"), ("mf", "hoisted"),
    ("wrap", "in_loop"), ("mha", "per_block"), ("repeat", "per_block"),
])
def test_layout_matches_jax(name, layout):
    k1, k2 = K1.launches, K2.launches
    got = _port(name, **F32, **LAYOUTS[layout])
    assert (K1.launches, K2.launches) == (k1, k2)  # CPU: plain versions
    want = _jax(name, cache_dtype=jnp.float32, **LAYOUTS[layout])
    assert got.shape == want.shape == (2, STEPS, 18)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("name,a,b", [
    ("mf", "per_block", "in_loop"), ("mf", "in_loop", "hoisted"),
    ("wrap", "in_loop", "hoisted"), ("wrap", "per_block", "in_loop"),
    ("mha", "per_block", "in_loop"),
])
def test_layouts_agree(name, a, b):
    np.testing.assert_allclose(_port(name, **F32, **LAYOUTS[a]),
                               _port(name, **F32, **LAYOUTS[b]), atol=1e-4)


def test_fallbacks_to_per_block_and_auto_hoist():
    """repeat_with_encoder and int8 fall back to per_block; "auto" hoists
    only on the shared layout without mha other-modality embeddings."""
    np.testing.assert_array_equal(
        _port("repeat", **F32),
        _port("repeat", **F32, kv_layout="per_block"))
    np.testing.assert_array_equal(
        _port("mha", **F32), _port("mha", **F32, **LAYOUTS["in_loop"]))
    np.testing.assert_array_equal(
        _port("mf", **F32, fused_rollout=False),
        _port("mf", **F32, **LAYOUTS["hoisted"], fused_rollout=False))


def test_bf16_and_int8_track_f32():
    want = _jax("mf", cache_dtype=jnp.float32, kv_layout="per_block")
    bf16 = _port("mf", kv_layout="per_block")
    int8 = _port("mf", cache_dtype=torch.int8)
    for got in (bf16, int8):
        assert np.isfinite(got).all()
    np.testing.assert_allclose(bf16, want, atol=5e-2)
    np.testing.assert_allclose(int8, want, atol=1e-1)
    np.testing.assert_allclose(int8, bf16, atol=1e-1)


def test_refusals_match_jax():
    with pytest.raises(ValueError, match="hoist_encoders"):
        _port("mha", hoist_encoders=True)
    with pytest.raises(ValueError, match="hoist_encoders"):
        _port("mf", kv_layout="per_block", hoist_encoders=True)
    with pytest.raises(ValueError, match="fused_rollout"):
        _port("mf", hoist_encoders=False, fused_rollout=True)
    for cfg, dtypes, kw, match in [
        (MF_CFG, (jnp.float32, torch.float32), dict(kv_layout="ring"),
         "kv_layout must be"),
        (_cfg("repeat"), (jnp.float32, torch.float32),
         dict(kv_layout="shared"), "repeat_with_encoder"),
        (MF_CFG, (jnp.int8, torch.int8), dict(kv_layout="shared"),
         "int8"),
        (MF_CFG, (jnp.float32, torch.float32),
         dict(kv_layout="per_block", hoisted=True), "hoisted"),
    ]:
        with pytest.raises(ValueError, match=match):
            jax_init_states(cfg, 1, dtypes[0], **kw)
        with pytest.raises(ValueError, match=match):
            G._init_metaformer_states(cfg, 1, dtypes[1], **kw)


@pytest.mark.parametrize("cfg_name,kw", [
    ("mf", dict(kv_layout="per_block")),
    ("mha", dict(kv_layout="shared")),
    ("mha", dict(kv_layout="shared", hoisted=True)),
    ("repeat", dict(kv_layout="per_block")),
])
def test_state_structure_matches_jax(cfg_name, kw):
    """The same tree of rings, shapes and Nones as JAX builds."""
    cfg = _cfg(cfg_name)
    want = jax_init_states(cfg, 2, jnp.float32, **kw)
    got = G._init_metaformer_states(cfg, 2, torch.float32, **kw)

    def walk(p, j):
        if j is None:
            assert p is None
        elif isinstance(j, dict):
            assert set(p) == set(j)
            for k in j:
                walk(p[k], j[k])
        elif isinstance(j, list):
            assert isinstance(p, list) and len(p) == len(j)
            for a, b in zip(p, j):
                walk(a, b)
        elif np.ndim(j) == 0:
            assert int(p) == int(j)
        else:
            assert tuple(p.shape) == tuple(j.shape)

    walk(got, want)
