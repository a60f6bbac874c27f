"""PyTorch port: parameters sharded over a 'model' mesh axis, on the CPU.

JAX lays its devices out as a (data, model) mesh and, with a 'model' axis
above 1, places every parameter and its optimizer state by
``parallel/mesh.py param_sharding``; the port lays its process group out
as the same grid (``parallel/mesh.py make_mesh_2d``), each rank storing
its slice of what that rule splits (``parallel/distributed.py
shard_parameters``) and gathering whole weights for each step.

  * ``param_sharding`` against JAX's rule on every leaf of the shipped
    yamls' flagship, lws and GRU Metaformer trees (flax shapes by
    ``jax.eval_shape``) at model 2, 3 and 4, through ``state_dict_from_jax``'s
    names and transposes; and on hand-picked leaves: a square Dense
    kernel (JAX's tie goes to the input dim: the port's dim 1), dims that
    do not divide, LayerNorm scales and the recurrent names.
  * The grid: rank r at (r // model, r % model); a mesh without a group
    of its size raises.
  * Spawned gloo ranks (``parallel/multihost_dryrun.py``, each a fresh
    process waited on with a timeout): three SGD steps of the dryrun's
    Metaformer (hidden 64, B 8) on a (1, 2) mesh (two processes) and a (2,
    2) mesh (four) against one process, for every step path (f32, bf16,
    remat, ``MultiSteps`` accumulation, the scheduled-sampling rollout):
    the loss within 1e-5 relative (JAX's bound in
    tests/test_harness.py:285), the parameters within 1e-4 of the
    tensor's largest (``chip_smoke.py DP_PARAM_TOL``), the ranks' losses
    and gathered parameters the same bits, each rank storing half of the
    split parameters' elements and of their optimizer state. On (1, 2)
    nothing is averaged, and the step is the single process's bits. On
    (2, 2) the bf16 step is held to ``DP_LOSS_TOL`` (1e-4) on the loss, as
    ``chip_smoke.py`` holds bf16 data parallel: splitting the rows over
    'data' moves the f32 mean by an ulp, which bf16's rounding amplifies
    to 4.7e-5 relative by the third step (the same 4.8e-5 on a data-only
    (4, 1) mesh: it is the bf16 step's, not the sharding's).
  * The (1, 2) sharded lws step against JAX's replicated step on the same
    weights and batch (JAX in its TPU configuration, the Pallas calls in
    interpret mode): losses within 1e-5 relative, parameters within 1e-5.
  * A (1, 2) ``Trainer.fit``: validation within 1e-4 of one process, rank
    0 alone writing, its ``last`` checkpoint loading ``strict=True`` into
    one process's model equal to the ranks' gathered parameters; a resume
    from it on the mesh, held the same way.

Not marked ``slow``: the spawns take about 40 s of one worker.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.experimental import pallas as pl

from multimodalreactiongeneration_tpu.models.lstm_with_sampling import (
    LSTMwithSample as JaxLSTMwithSample,
)
from multimodalreactiongeneration_tpu.models.lstmformer import (
    Metaformer as JaxMetaformer,
)
from multimodalreactiongeneration_tpu.parallel import mesh as jmesh
from multimodalreactiongeneration_tpu.train import harness as jharness
from multimodalreactiongeneration_tpu.train import optim as joptim
from multimodalreactiongeneration_tpu.utils.config import from_dict
from multimodalreactiongeneration_tpu_torch import configs
from multimodalreactiongeneration_tpu_torch.models.lstm_with_sampling import (
    LSTMwithSample,
)
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.models.weights import (
    state_dict_from_jax,
)
from multimodalreactiongeneration_tpu_torch.parallel import mesh
from multimodalreactiongeneration_tpu_torch.parallel import (
    multihost_dryrun as dryrun,
)
from tests.test_streaming_models import LWS_CFG
from tests.test_torch_port_weights import flat_params, np_batch

DP_LOSS_TOL, DP_PARAM_TOL = 1e-4, 1e-4  # chip_smoke.py's
TREES = {
    "flagship": (JaxMetaformer, Metaformer, configs.LSTMFORMER_MODEL_CFG),
    "lws": (JaxLSTMwithSample, LSTMwithSample, configs.LWS_MODEL_CFG),
    "gru": (JaxMetaformer, Metaformer, configs.LSTMFORMER_GRU_MODEL_CFG),
}


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(flax leaf path -> shape, the port model) of a shipped yaml's tree."""
    jcls, pcls, cfg = TREES[name]
    batch = [jnp.asarray(x) for x in np_batch(0, T=4, lead=2)[:6]]
    shapes = jax.eval_shape(jcls(cfg=cfg).init, jax.random.PRNGKey(0),
                            *batch)
    flat = {"/".join(k): v for k, v in flatten_dict(shapes).items()}
    return flat, pcls(cfg, device="cpu")


def _jax_dims(flat, size):
    """JAX's ``param_sharding`` on the flax shapes, as the port's names and
    dims (``state_dict_from_jax``: a kernel transposed, a scale renamed)."""
    jm = jmesh.make_mesh_2d(1, size)
    tree = unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    specs = flatten_dict(jmesh.param_sharding(tree, jm))
    out = {}
    for key, sharding in specs.items():
        path = "/".join(key)
        spec = list(sharding.spec) + [None] * len(flat[path].shape)
        dim = next((d for d, a in enumerate(spec) if a == "model"), None)
        parts = list(key[1:] if key[0] == "params" else key)
        if parts[-1] == "kernel" and dim is not None:
            dim = 1 - dim
        if parts[-1] in ("kernel", "scale"):
            parts[-1] = "weight"
        out[".".join(parts)] = dim
    return out


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_sharding_matches_jax(tree, size):
    flat, port = _trees(tree)
    want = _jax_dims(flat, size)
    got = mesh.param_sharding(port, mesh.DataMesh(model=size))
    assert got == want
    shapes = dict(port.named_parameters())
    assert {n: tuple(shapes[n].shape) for n in got} == {
        n: tuple(v.shape) for n, v in state_dict_from_jax(
            {k: np.zeros(s.shape, np.float32) for k, s in flat.items()}
        ).items()}
    recurrent = [n for n in got if "weight_hh" in n or "bias_ih" in n]
    assert recurrent and all(got[n] is None for n in recurrent)
    assert any(d is not None for d in got.values())


def test_param_sharding_hand_picked_leaves():
    """A square Dense kernel splits on JAX's dim 0 (the tie goes to the
    lower dim), the port's dim 1; a (81 -> 18) kernel on its 18 outputs at
    model 2, its 81 inputs at model 3 and nowhere at 4; scales and biases
    on their one dim where it divides; the recurrent names stay whole
    whatever their shape."""
    z = torch.zeros
    params = {"a.weight": z(256, 256), "a.bias": z(256),
              "b.weight": z(256, 81), "c.weight": z(18, 81),
              "norm.weight": z(18),
              "mixer.weight_hh_l0": z(1024, 256), "mixer.bias_ih_l0": z(1024),
              "mha.q_proj_weight": z(256, 256), "mha.out_proj_bias": z(256)}
    got = {m: mesh.param_sharding(params, mesh.DataMesh(model=m))
           for m in (2, 3, 4)}
    assert got[2] == {"a.weight": 1, "a.bias": 0, "b.weight": 0,
                      "c.weight": 0, "norm.weight": 0,
                      "mixer.weight_hh_l0": None, "mixer.bias_ih_l0": None,
                      "mha.q_proj_weight": 0, "mha.out_proj_bias": 0}
    assert got[3] == dict.fromkeys(params) | {"b.weight": 1, "c.weight": 1,
                                              "norm.weight": 0}
    assert got[4] == dict(got[2], **{"c.weight": None, "norm.weight": None})
    assert mesh.flax_leaf("x.weight_hh_l0", (8, 2)) == (
        "x/weight_hh_l0", (8, 2), False)


def test_mesh_grid_and_axis_groups():
    """Rank r at (r // model, r % model), 'model' the minor axis; a mesh
    of more ranks than the process group raises, as does an axis of more
    than one rank without its group."""
    grid = [mesh.DataMesh(data=2, model=3, rank=r) for r in range(6)]
    assert [(m.data_rank, m.model_rank) for m in grid] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert grid[4].shape == {"data": 2, "model": 3} and grid[4].world_size == 6
    with pytest.raises(ValueError, match="outside"):
        mesh.DataMesh(data=1, model=2, rank=2)
    with pytest.raises(ValueError, match="1x2 mesh needs 2 processes"):
        mesh.make_mesh_2d(1, 2)
    one = mesh.DataMesh(data=1, model=2)
    assert one.group("data") is None
    with pytest.raises(RuntimeError, match="no process group"):
        one.group("model")
    rows = mesh.shard_batch(mesh.DataMesh(data=2, model=2, rank=3),
                            np.arange(8))
    np.testing.assert_array_equal(rows, [4, 5, 6, 7])


@pytest.fixture(scope="module")
def mesh_1x2():
    return dryrun.readings(
        [dryrun.step_request(dryrun.VARIANTS, (1, 2), steps=3, tag="m12"),
         dryrun.fit_request(1, (1, 2), tag="fit12", resume=True)],
        2, timeout=300.0)


@pytest.fixture(scope="module")
def mesh_2x2():
    return dryrun.readings(
        [dryrun.step_request(dryrun.VARIANTS, (2, 2), steps=3, tag="m22")],
        4, timeout=300.0)[0]


@pytest.mark.parametrize("variant", dryrun.VARIANTS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_sharded_steps_match_one_process(mesh_1x2, mesh_2x2, shape, variant):
    r = (mesh_1x2[0] if shape == "1x2" else mesh_2x2)[variant]
    data = int(shape[0])
    assert r["mesh"] == [data, 2]
    assert r["rows"] == [8] + [8 // data] * (2 * data)
    assert not r["single_ddp"] and not r["single_launches"]
    for losses in [r["single"]] + r["ranks"]:
        assert len(losses) == 3 and np.isfinite(losses).all()
    # a bf16 step moves the data axis's mean of the gradients by its
    # rounding: after the first update the loss is held as phase 35 holds
    # bf16 (DP_LOSS_TOL); the (4, 1) mesh, with no model axis, drifts as
    # far (tools/mesh_bf16_seeds.py). The first loss reads the parameters
    # as drawn, before any update: 1e-5 relative.
    bf16_split = variant == "bf16" and data > 1
    dryrun.check_steps(r, loss_tol=DP_LOSS_TOL, param_tol=DP_PARAM_TOL,
                       rank_tol=0.0,
                       loss_rel_tol=None if bf16_split else 1e-5)
    for losses in r["ranks"]:
        assert abs(losses[0] - r["single"][0]) <= 1e-5 * abs(r["single"][0])
    if data == 1:  # nothing averaged: the single process's step
        assert r["loss_err"] == 0.0 and r["param_err"] == 0.0


def test_sharded_fit_checkpoints_load_whole(mesh_1x2):
    """Asserted by ``fit_request``: here the readings it held."""
    r = mesh_1x2[1]
    assert r["val_err"] <= 1e-4 and r["ckpt_strict_err"] == 0.0
    assert r["wrote_metrics"] == [True, False]
    assert r["ckpts"][0] == ["V0-%.6f" % r["single"][0], "last"]
    resumed = r["resumed"]
    assert len(resumed["single"]) == 1 and resumed["val_err"] <= 1e-4
    assert resumed["ckpt_strict_err"] == 0.0
    assert resumed["frames"][1] == resumed["frames"][0]


LWS = dict(LWS_CFG, sampler_num_layers=2)
LWS_LOSS = dict(loss_type="huber", loss_reduction="mean", huber_delta=1.0,
                delta_loss_scale=1.0)
LWS_METRICS = dict(use_centroid=True, use_angle=True, delta_order=2)
LWS_SGD = dict(use_optimizer="sgd", lr=1e-2, weight_decay=1e-3, momentum=0.9,
               use_lr_sched=False)


def test_sharded_lws_step_matches_jax(tmp_path, monkeypatch):
    """tests/test_torch_port_lws.py's three SGD steps, the port's on a (1,
    2) mesh of two processes, JAX's replicated."""
    monkeypatch.setenv("MRGEN_RNN_IMPL", "pallas")
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    batch = np_batch(50, T=4, lead=2)
    rng = np.random.default_rng(51)
    batch[6][rng.random(batch[6].shape[:2]) < 0.1] = -100.0
    batch[2][1, -3:] = -100.0
    jm = JaxLSTMwithSample(cfg=LWS)
    params = jax.jit(jm.init)(jax.random.PRNGKey(52),
                              *[jnp.asarray(x) for x in batch[:6]])
    torch.save(state_dict_from_jax(flat_params(params)), tmp_path / "w.pt")
    np.savez(tmp_path / "batch.npz", **{f"a{i}": x
                                        for i, x in enumerate(batch)})

    model_cfg = dict(LWS, **LWS_LOSS)
    jopt = joptim.build_optimizer(from_dict(LWS_SGD))
    jtrain, _ = jharness.streaming_step_fns(
        jm, model_cfg, LWS_METRICS, jopt, mask_self_motion_input=False)
    jtrain = jax.jit(jtrain)
    jbatch = [(jnp.asarray(x), jnp.zeros(x.shape[0], jnp.int32))
              for x in batch]
    state = jopt.init(params)
    jlosses = []
    for _ in range(3):
        params, state, jloss, _ = jtrain(params, state, jbatch,
                                         jax.random.PRNGKey(0))
        jlosses.append(float(jloss))

    custom = dict(model_type="lstm_with_sampling", cfg=model_cfg,
                  metrics=LWS_METRICS, optim=LWS_SGD,
                  weights=str(tmp_path / "w.pt"),
                  batch_file=str(tmp_path / "batch.npz"))
    r = dryrun.readings([dryrun.step_request(
        ("f32",), (1, 2), steps=3, tag="lws", custom=custom)], 2,
        timeout=300.0)[0]["f32"]
    assert all(r["rank_sharded"]) and r["rank_param_err"] == 0.0
    for losses in r["ranks"]:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = state_dict_from_jax(flat_params(params))
    got = r["params"]
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
