"""PyTorch port: the fused decode rollout vs the JAX package.

``fold_decode_params`` must fold the same panels as the JAX fold
(atol 1e-6), and the port's plain ``decode_rollout_reference`` must
match the JAX Pallas ``decode_rollout`` run in interpret mode (its
pallas_call patched as tests/test_pallas_decode_rollout.py does) on the
same folded weights, rings and streams, f32, atol 2e-5 (the JAX test's
bound) -- with the full, teacher and scheduled masks and across ring
wrap. The CUDA kernel is held to the plain version on the card in
tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.ops import pallas_decode_rollout as jdr
from multimodalreactiongeneration_tpu_torch.models.lstmformer import (
    context_budgets,
)
from multimodalreactiongeneration_tpu_torch.ops import decode_rollout as pdr
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _folds(cfg, seed):
    jm, params, pm = paired_models(cfg, seed, np_batch(seed))
    with jax.default_matmul_precision("highest"):
        jf = jdr.fold_decode_params(params, cfg["num_block"],
                                    cfg["num_heads"], mm_dtype=jnp.float32)
    pf = pdr.fold_decode_params(pm, cfg["num_block"], cfg["num_heads"],
                                mm_dtype=torch.float32)
    return jf, pf


def test_fold_matches_jax():
    jf, pf = _folds(MF_CFG, 11)
    out_dim = pf["out_dim"]
    assert out_dim == jf["out_dim"] == 18
    for key in pdr._W_KEYS + ["emb0_w", "emb0_b"]:
        want = np.asarray(jf[key])
        if key in ("wo2", "bo2"):  # the TPU layout pads to 128 lanes
            want = want[..., :out_dim]
        got = pf[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=key)


def _rollout_inputs(cfg, seed, mask, steps=6, batch=2):
    rng = np.random.default_rng(seed)
    h, nb = cfg["hidden_size"], cfg["num_block"]
    sa, bud_m = context_budgets(cfg)
    sm_pad = bud_m + (-bud_m) % 8
    ratio = 8

    def r(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    arrays = (r(batch, sa, h), r(batch, sm_pad, h), r(nb, batch, h, s=0.5),
              r(nb, batch, h, s=0.5), r(batch, h), r(steps, batch, ratio, h),
              r(steps, batch, h), r(steps, batch, h),
              np.asarray(mask, np.float32))
    kw = dict(heads=cfg["num_heads"], ratio=ratio, len_a0=2 * ratio,
              len_m0=2, bud_m=bud_m)
    return arrays, kw


@pytest.mark.parametrize("case", ["full", "teacher", "scheduled", "wrap"])
def test_reference_matches_jax_kernel(case):
    cfg = dict(MF_CFG, max_context_len=0.32) if case == "wrap" else MF_CFG
    steps = 6
    mask = {
        "full": np.ones(steps, bool),
        "wrap": np.ones(steps, bool),
        "teacher": np.zeros(steps, bool),
        "scheduled": np.random.default_rng(5).random(steps) < 0.5,
    }[case]
    jf, pf = _folds(cfg, 21)
    arrays, kw = _rollout_inputs(cfg, 22, mask, steps)
    if case == "wrap":  # the rings overwrite mid-rollout
        assert kw["len_a0"] + steps * kw["ratio"] > arrays[0].shape[1]
        assert kw["len_m0"] + steps > kw["bud_m"]
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdr.decode_rollout(
            jf, *[jnp.asarray(a) for a in arrays], **kw))
    got = pdr.decode_rollout_reference(
        pf, *[torch.from_numpy(a) for a in arrays], **kw)
    assert got.shape == want.shape == (steps, 2, 18)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_only():
    cfg = MF_CFG
    _, pf = _folds(cfg, 31)
    arrays, kw = _rollout_inputs(cfg, 32, np.ones(4, bool), steps=4)
    tensors = [torch.from_numpy(a) for a in arrays]
    before = pdr.launches
    got = pdr.decode_rollout(pf, *tensors, **kw)
    assert pdr.launches == before
    np.testing.assert_array_equal(
        got.numpy(), pdr.decode_rollout_reference(pf, *tensors, **kw).numpy())
    with pytest.raises(ValueError, match="no kernel"):
        pdr.decode_rollout(pf, *[t.to("meta") for t in tensors], **kw)
