"""PyTorch port vs the JAX package: basic layers, masks, ring buffer,
LSTM and multi-head attention, f32 on CPU (atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer import cache as jcache
from multimodalreactiongeneration_tpu.nn import attention as jattn
from multimodalreactiongeneration_tpu.nn import basic as jbasic
from multimodalreactiongeneration_tpu.nn import recurrent as jrec
from multimodalreactiongeneration_tpu.ops import masks as jmasks
from multimodalreactiongeneration_tpu_torch.infer import cache as pcache
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.nn import attention as pattn
from multimodalreactiongeneration_tpu_torch.nn import basic as pbasic
from multimodalreactiongeneration_tpu_torch.nn import recurrent as prec
from multimodalreactiongeneration_tpu_torch.ops import masks as pmasks
from tests.test_torch_port_weights import flat_params

torch.set_num_threads(1)
ATOL = 1e-5


def _port(module, params):
    module.load_state_dict(state_dict_from_jax(flat_params(params)),
                           strict=True)
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("nonlinearity,residual", [
    ("none", True), ("relu", True), ("relu", False),
])
def test_feed_forward(nonlinearity, residual):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    jm = jbasic.FeedForward(hidden_size=16, bottleneck_size=8,
                            nonlinearity=nonlinearity, residual=residual,
                            residual_layer_norm=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm = _port(pbasic.FeedForward(16, torch.Generator(), bottleneck_size=8,
                                  nonlinearity=nonlinearity,
                                  residual=residual,
                                  residual_layer_norm=True), params)
    got = pm(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("q_len,k_len", [(6, 48), (48, 6), (6, 6)])
def test_masks(q_len, k_len):
    np.testing.assert_array_equal(
        pmasks.rectangular_causal_mask(q_len, k_len).numpy(),
        np.asarray(jmasks.rectangular_causal_mask(q_len, k_len)),
    )
    rng = np.random.default_rng(q_len + k_len)
    q = rng.standard_normal((2, q_len, 3)).astype(np.float32)
    k = rng.standard_normal((2, k_len, 3)).astype(np.float32)
    q[0, -2:, 0] = -100.0
    k[0, -3:, 0] = -100.0
    k[1, :2, 0] = -100.0
    np.testing.assert_array_equal(
        pmasks.merged_attention_mask(_t(q), _t(k)).numpy(),
        np.asarray(jmasks.merged_attention_mask(jnp.asarray(q),
                                                jnp.asarray(k))),
    )
    with pytest.raises(ValueError):
        pmasks.rectangular_causal_mask(4, 6)


@pytest.mark.parametrize("with_chunk_mask", [False, True])
def test_raw_cache_extend_across_wrap(with_chunk_mask):
    rng = np.random.default_rng(1)
    jc = jcache.raw_cache_init(2, 5, 4)
    pc = pcache.raw_cache_init(2, 5, 4)
    for n in (3, 3, 2, 4):  # wraps on the second chunk and again later
        chunk = rng.standard_normal((2, n, 4)).astype(np.float32)
        cm = None
        if with_chunk_mask:
            cm = rng.random((2, 2, n)) < 0.5
        jc, jx, jmask = jcache.raw_cache_extend(
            jc, jnp.asarray(chunk),
            chunk_mask=None if cm is None else jnp.asarray(cm))
        pc, px, pmask = pcache.raw_cache_extend(
            pc, _t(chunk), chunk_mask=None if cm is None else _t(cm))
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        assert pc["length"] == int(jc["length"])
    with pytest.raises(ValueError):
        pcache.raw_cache_extend(pc, torch.zeros(2, 6, 4))


@pytest.mark.parametrize("t,with_state", [(7, False), (19, True)])
def test_torch_lstm(t, with_state):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, 12)).astype(np.float32)
    hx = None
    if with_state:
        hx = tuple(0.5 * rng.standard_normal((1, 3, 16)).astype(np.float32)
                   for _ in range(2))
    jm = jrec.TorchLSTM(input_size=12, hidden_size=16, impl="scan")
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        jy, (jh, jc) = jm.apply(
            params, jnp.asarray(x),
            None if hx is None else tuple(jnp.asarray(v) for v in hx))
    pm = _port(prec.TorchLSTM(12, 16, torch.Generator()), params)
    py, (ph, pc) = pm(_t(x), None if hx is None else tuple(map(_t, hx)))
    for got, want in ((py, jy), (ph, jh), (pc, jc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


def _mha_pair(seed, e=16, heads=4):
    jm = jattn.TorchMHA(embed_dim=e, num_heads=heads, kdim=e, vdim=e)
    z = jnp.zeros((2, 3, e))
    params = jm.init(jax.random.PRNGKey(seed), z, z, z)
    # non-zero biases, so the k-bias cancellation and v-bias restore of
    # attend_raw are exercised
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray, params)
    for name in ("q_proj_bias", "k_proj_bias", "v_proj_bias",
                 "out_proj_bias"):
        p["params"][name] = 0.3 * rng.standard_normal(e).astype(np.float32)
    pm = _port(pattn.TorchMHA(e, heads, torch.Generator(), kdim=e, vdim=e),
               p)
    return jm, p, pm


def _mask_with_dead_row(rng, b, lq, s):
    mask = rng.random((b, lq, s)) < 0.4
    mask[0, 1, :] = True  # a fully masked query row
    return mask


def test_mha_call_masked_with_fully_masked_row():
    rng = np.random.default_rng(3)
    jm, params, pm = _mha_pair(3)
    q = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = _mask_with_dead_row(rng, 2, 5, 9)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(params, jnp.asarray(q), jnp.asarray(kv),
                                   jnp.asarray(kv), jnp.asarray(mask)))
    got = pm(_t(q), _t(kv), _t(kv), _t(mask)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the dead row is the finite uniform average over keys (PARITY #4)
    _, v = pm.project_kv(_t(kv), _t(kv))
    uniform = v[0].mean(0) @ pm.out_proj_weight.T + pm.out_proj_bias
    np.testing.assert_allclose(got[0, 1], uniform.detach().numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mha_attend_raw_with_fully_masked_row(cache_dtype):
    rng = np.random.default_rng(4)
    jm, params, pm = _mha_pair(4)
    q = rng.standard_normal((2, 3, 16)).astype(np.float32)
    raw = rng.standard_normal((2, 11, 16)).astype(np.float32)
    mask = _mask_with_dead_row(rng, 2, 3, 11)
    jdt = jnp.float32 if cache_dtype == "float32" else jnp.bfloat16
    pdt = torch.float32 if cache_dtype == "float32" else torch.bfloat16
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(
            params, jnp.asarray(q), jnp.asarray(raw).astype(jdt),
            jnp.asarray(mask), method=jattn.TorchMHA.attend_raw,
        ), dtype=np.float32)
        # attend_raw is an exact reassociation of the plain call
        plain = np.asarray(jm.apply(params, jnp.asarray(q),
                                    jnp.asarray(raw), jnp.asarray(raw),
                                    jnp.asarray(mask)))
    got = pm.attend_raw(_t(q), _t(raw).to(pdt), _t(mask)).detach().numpy()
    assert np.isfinite(got).all()
    # bf16 operands round inside both implementations at the same places;
    # the tolerance covers rounding-boundary flips of single elements
    np.testing.assert_allclose(got, want,
                               atol=ATOL if pdt == torch.float32 else 2e-2)
    if pdt == torch.float32:
        np.testing.assert_allclose(got, plain, atol=ATOL)
