"""PyTorch port: ``infer/serving.py ServingEngine`` over a mesh, on the CPU.

JAX's ``ServingEngine(mesh=...)`` shards the slot pool over a 'data' mesh
axis and replicates the parameters; the port splits the pool over the
data axis of its process group, one process per card, each rank holding
a contiguous block of ``slots / data`` rows, every call made on every
rank (``parallel/multihost_dryrun.py serving_request``: two spawned gloo
ranks, each a fresh process waited on with a timeout, one launch for the
whole file). On ``MF_CFG`` (hidden 32, 2 blocks) with weights crossed by
``state_dict_from_jax``, leads and inputs from numpy seeds (a lead of 3
frames, 1280-sample hops), f32 rings:

  * 8 slots, all attached, 2 steps (JAX's tests/test_serving.py:203):
    every rank's outputs equal the one-process engine's within 1e-5, and
    JAX's engine on a 2-device mesh within 1e-4 (the f32 bound of
    tests/test_torch_port_serving.py test_single_slot_matches_jax_
    replication);
  * staggered attaches, a detach and a reattach: the same slots taken on
    every rank as in one process, the outputs within 1e-5, detached rows
    zero, each attach primed by its owner alone;
  * ``slots % data`` raises ValueError, on the ranks and in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.infer.serving import (
    ServingEngine as JaxServingEngine,
)
from multimodalreactiongeneration_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from multimodalreactiongeneration_tpu_torch.infer.serving import (
    ServingEngine,
)
from multimodalreactiongeneration_tpu_torch.parallel import mesh
from multimodalreactiongeneration_tpu_torch.parallel import (
    multihost_dryrun as dryrun,
)
from tests.test_streaming_models import MF_CFG
from tests.test_torch_port_weights import np_batch, paired_models

torch.set_num_threads(1)
LEAD, HOP, SLOTS = 3, 1280, 8
ALL = [(0, "attach", i) for i in range(SLOTS)]
# slot s attaches at step s // 2; slots 1 and 5 detach at step 3 and two
# new sessions take them back at once
STAGGERED = ([(s // 2, "attach", s) for s in range(SLOTS)]
             + [(3, "detach", 1), (3, "detach", 5), (3, "attach", 8),
                (3, "attach", 9)])


def _leads(n):
    out = [[], [], []]
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        out[0].append(rng.normal(size=(1, LEAD * 8, 81)))
        out[1].append(rng.normal(size=(1, LEAD, 18)))
        out[2].append(rng.normal(size=(1, LEAD, 18)))
    return [np.stack(x).astype(np.float32) for x in out]


def _feeds(seed, steps):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal((steps, SLOTS, HOP))).astype(
                np.float32),
            rng.normal(size=(steps, SLOTS, 1, 18)).astype(np.float32))


def _drive(engine, leads, feeds, events):
    """The calls ``multihost_dryrun.serve`` makes, on one engine."""
    outs, taken = [], []
    for t in range(len(feeds[0])):
        for when, what, arg in events:
            if when != t:
                continue
            if what == "attach":
                taken.append(engine.attach(*[x[arg] for x in leads]))
            else:
                engine.detach(arg)
        outs.append(engine.step(feeds[0][t], feeds[1][t]))
    return np.stack(outs), taken


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jm, params, pm = paired_models(MF_CFG, 81, np_batch(80))
    tmp = tmp_path_factory.mktemp("serve_mesh")
    torch.save(pm.state_dict(), tmp / "w.pt")
    leads = _leads(10)
    runs = {"all": (_feeds(9, 2), ALL), "staggered": (_feeds(7, 5),
                                                      STAGGERED)}
    requests = []
    for tag, (feeds, events) in runs.items():
        np.savez(tmp / f"{tag}.npz", lead_audio=leads[0], lead_mp=leads[1],
                 lead_ms=leads[2], audio=feeds[0], mp=feeds[1])
        requests.append(dryrun.serving_request(
            MF_CFG, str(tmp / "w.pt"), str(tmp / f"{tag}.npz"), events,
            SLOTS, "f32", mesh_shape=(2, 1), refuse_slots=3, tag=tag))
    got = dryrun.readings(requests, 2, timeout=300.0)
    return (jm, params, pm, leads, runs,
            dict(zip(runs, got)))


def test_mesh_engine_matches_one_process(served):
    _, _, pm, leads, runs, got = served
    for tag, (feeds, events) in runs.items():
        want, taken = _drive(ServingEngine(pm, slots=SLOTS,
                                           cache_dtype=torch.float32),
                             leads, feeds, events)
        assert want.shape == (len(feeds[0]), SLOTS, 1, 18)
        for rank, out in enumerate(got[tag]["outputs"]):
            np.testing.assert_allclose(out, want, atol=1e-5,
                                       err_msg=f"{tag} rank {rank}")
        assert got[tag]["slots_taken"] == [taken, taken]


def test_mesh_engine_matches_jax_mesh_engine(served):
    jm, params, _, leads, runs, got = served
    feeds, events = runs["all"]
    engine = JaxServingEngine(jm, params, slots=SLOTS,
                              mesh=jax_make_mesh(2),
                              cache_dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        want, _ = _drive(engine, leads, feeds, events)
    for out in got["all"]["outputs"]:
        np.testing.assert_allclose(out, want, atol=1e-4)


def test_mesh_attach_detach_reattach(served):
    """Ranks 0 and 1 own slots 0-3 and 4-7: each attach primed on its
    owner alone (10 attaches, 4 + 4 slots then 1 + 1 retaken); the
    detached rows are zeros until the slots are taken back."""
    _, _, _, _, runs, got = served
    r = got["staggered"]
    assert r["local_slots"] == [4, 4]
    assert r["slots_taken"][0] == list(range(8)) + [5, 1]
    assert r["owned"] == [5, 5]
    outs = r["outputs"][0]
    assert (outs[0, 2:] == 0).all() and (outs[0, :2] != 0).all()
    assert (outs[2, :6] != 0).all() and (outs[2, 6:] == 0).all()
    assert (outs[3] != 0).all()


def test_slots_must_divide_the_data_axis(served):
    assert served[5]["all"]["refused"] == [True, True]
    pm = served[2]
    with pytest.raises(ValueError, match="3 slots do not divide"):
        ServingEngine(pm, slots=3, mesh=mesh.DataMesh(data=2))
    one = ServingEngine(pm, slots=3, mesh=mesh.make_mesh())
    assert one.local_slots == 3 and all(one.owns(s) for s in range(3))
