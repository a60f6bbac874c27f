"""PyTorch port: the flagship Metaformer's gradient-free forward and
generation on bf16 parameters (K1's bf16 mode on the card) vs the JAX
package on the CPU.

JAX runs these as ``model.apply`` and ``generate_metaformer`` on
``_cast_tree(params, bf16)`` (its harness's bf16 cast); the port as the
model cast to bf16 (``model.to(torch.bfloat16)``) under ``torch.no_grad()``.
The JAX side runs as its own tests run it: the Pallas calls in interpret
mode, ``MRGEN_RNN_IMPL=pallas`` and ``MRGEN_FUSED_ATTN=force``, so its
encoder stacks take ``mixer_stack_recurrence``'s light forward (K1, bf16
operands) as the port's do; the forward is compiled with
``xla_allow_excess_precision`` off (tests/test_torch_port_bf16_train.py
says why). A Metaformer at hidden 128 (the width whose self-motion LSTMs
take K7's route), 2 blocks, 2-block encoders, T 24, lead 4.

  * The forward, over three model seeds: each kernel entry's operand
    dtypes are JAX's (spied on both sides: two encoder stacks with bf16
    weights, two self-motion LSTMs, four integrators); the outputs within
    JAX's bf16 bound, 5e-2 absolute (tests/test_pallas_lstm.py), and on
    average within ``BF16_MODE_FRAC`` (a quarter) of the distance between
    the port's f32 forward and JAX's bf16 one. Observed: the bf16 forward
    at most 3.2e-3 (mean 2.0e-5 to 8.8e-5, 0.006-0.021 of the distance);
    the f32 forward 1.9e-2 to 2.5e-2 (mean 3.2e-3 to 4.2e-3). The f32
    control passes the 5e-2 bound and fails the distance one (it reads 1
    by construction), so the distance test is what tells the two apart.
  * Generation (teacher-forced, 24 steps) on the module loop, the path
    JAX's ``fused_rollout="auto"`` takes off the TPU: within JAX's
    teacher-forced bf16 decode bound, 0.032 absolute
    (ops/pallas_decode_rollout.py), with the f32 and the bf16 cache; with
    the f32 cache (the generation eval's) on average within a quarter of
    the f32 control's distance. Observed: f32 cache at most 5.7e-4 (mean
    5.1e-6 to 4.1e-5, 0.002-0.017 of the distance), bf16 cache at most
    2.2e-3; the f32 control 1.5e-2 to 1.7e-2 (f32 cache) and 3.4e-3 to
    6.6e-3 (bf16 cache, where the ring's rounding dominates and the
    control reads within the bound).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.infer import generate as JG
from multimodalreactiongeneration_tpu.train.harness import _cast_tree
from multimodalreactiongeneration_tpu_torch.infer import generate as G
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_bf16_flagship import _spy_kernel_entries
from tests.test_torch_port_train import _train_batch
from tests.test_torch_port_weights import paired_models

torch.set_num_threads(1)
BF = torch.bfloat16
CFG = dict(MF_CFG, hidden_size=128)
FWD_ATOL = 5e-2        # JAX's bf16 output bound (tests/test_pallas_lstm.py)
DECODE_ATOL = 0.032    # JAX's teacher-forced bf16 decode bound
BF16_MODE_FRAC = 0.25  # chip_smoke.py's distance test of a bf16 mode


@pytest.fixture(autouse=True)
def _kernel_routes(monkeypatch):
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setenv("MRGEN_FUSED_ATTN", "force")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _inputs(seed):
    """The six model inputs and the target, -100 padding zeroed (as the
    eval step masks the self-motion input)."""
    return [x * (x != -100.0) for x in _train_batch(50 + seed)]


def _distance_within(got, want, control):
    """The distance test: ``got``'s mean error from ``want`` at most
    ``BF16_MODE_FRAC`` of the f32 control's."""
    gap = float(np.abs(control - want).mean())
    return float(np.abs(got - want).mean()) <= BF16_MODE_FRAC * gap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_forward_without_gradient_matches_jax(seed, monkeypatch):
    batch = _inputs(seed)
    jm, params, pm = paired_models(CFG, seed, batch)
    logs = _spy_kernel_entries(monkeypatch)
    bparams = _cast_tree(params, jnp.bfloat16)
    jins = [jnp.asarray(x).astype(jnp.bfloat16) for x in batch[:6]]
    fwd = jax.jit(lambda p, *a: jm.apply(p, *a)[0]).lower(
        bparams, *jins).compile(
            compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fwd(bparams, *jins).astype(jnp.float32))
    with torch.no_grad():
        y32 = pm(*[torch.from_numpy(x) for x in batch[:6]])[0].numpy()
        for log in logs["port"]:  # the f32 forward's entries
            log.clear()
        y16 = pm.to(BF)(*[torch.from_numpy(x).to(BF)
                          for x in batch[:6]])[0]
    assert logs["port"] == logs["jax"]
    assert [len(log) for log in logs["port"]] == [2, 2, 4]
    assert all(d[1] == "bfloat16" for d in logs["port"][0])  # bf16 W_ih
    assert y16.dtype == torch.float32
    y16 = y16.numpy()
    assert np.abs(y16 - want).max() <= FWD_ATOL
    assert _distance_within(y16, want, y32)
    assert not _distance_within(y32, want, y32)


@pytest.mark.parametrize("seed", [0, 2])
def test_bf16_generation_matches_jax(seed):
    batch = _inputs(seed)
    jm, params, pm = paired_models(CFG, seed, batch)
    bparams = _cast_tree(params, jnp.bfloat16)
    mask = np.zeros(24, bool)
    tb = [torch.from_numpy(x) for x in batch]
    p16 = copy.deepcopy(pm).to(BF)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        want = np.asarray(JG.generate_metaformer(
            jm, bparams, tuple(jnp.asarray(x) for x in batch),
            jnp.asarray(mask), cache_dtype=jdt))
        y32 = G.generate_metaformer(pm, tb, torch.from_numpy(mask),
                                    cache_dtype=tdt,
                                    fused_rollout=False).numpy()
        y16 = G.generate_metaformer(p16, tb, torch.from_numpy(mask),
                                    cache_dtype=tdt,
                                    fused_rollout=False).numpy()
        assert y16.dtype == np.float32
        assert np.abs(y16 - want).max() <= DECODE_ATOL, jdt
        if tdt == torch.float32:
            assert _distance_within(y16, want, y32)
            assert not _distance_within(y32, want, y32)
