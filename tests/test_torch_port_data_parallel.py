"""PyTorch port: data-parallel training (``torch.distributed`` / DDP in
place of the JAX 'data' mesh axis), on the CPU.

  * ``HostRowShard`` against the JAX package's class on the same batches
    (numpy arrays and torch tensors): the same rows, steps and skips.
  * ``parallel/mesh.py``: ``pad_batch_to_devices`` against JAX's, and
    ``shard_batch`` against the rows ``NamedSharding(mesh, P('data'))``
    puts on each of the 8 virtual devices; the meshes a process group
    cannot be (a data axis wider than it, a 'model' axis) raise.
  * ``Trainer._stage`` without a process group: rows as given, on the
    device, contiguous; only rank 0 writes (``checkpoint.is_primary``).
  * ``initialize_multihost`` and the CLI with CUDA reported available:
    a CPU run joins over gloo and takes no card; ``rank_device``.
  * Two real processes over gloo (``parallel/multihost_dryrun.py``, one
    launch of two ranks and one of a single process, at once, ~15 s;
    one after the other, as the card times them, for the f32 path; each
    worker waited on with a timeout): two SGD steps of a small Metaformer
    (hidden 64, B 8 split 4 + 4) on each of the paths a train step takes
    (f32, bf16 through ``functional_call``, remat, ``MultiSteps``
    accumulation, the scheduled-sampling rollout). Every global loss is
    within 1e-4 of the single process's (observed at most 5.1e-7, bf16),
    the ranks' losses within 1e-6 of each other (observed 0) and their
    parameters the same bits, each rank's parameters within 1e-5 of the
    single process's relative to the tensor's largest (observed at most
    2.3e-6, bf16; DDP's bucketed all-reduce sums in another order). The
    ranks ran DDP; the single process did not.
  * A 2-epoch ``Trainer.fit`` on two processes against one: the
    validation history within 1e-4 (observed 3e-8), the same checkpoint
    files and trained frames, ``metrics.jsonl`` from rank 0 alone.

Not marked ``slow``: the file takes about a minute of one worker.
"""

import numpy as np
import pytest
import torch

from multimodalreactiongeneration_tpu.data.dataset import (
    HostRowShard as JaxHostRowShard,
)
from multimodalreactiongeneration_tpu.parallel import mesh as jmesh
from multimodalreactiongeneration_tpu_torch.data.dataset import HostRowShard
from multimodalreactiongeneration_tpu_torch.models.lstmformer import Metaformer
from multimodalreactiongeneration_tpu_torch.parallel import (
    distributed,
    mesh,
    multihost_dryrun as dryrun,
)
from multimodalreactiongeneration_tpu_torch.train import checkpoint as ckpt
from multimodalreactiongeneration_tpu_torch.train import harness, optim
from tests.test_streaming_models import MF_CFG

OPTIM = dict(use_optimizer="adam", lr=1e-3, weight_decay=1e-2, momentum=0.9,
             use_lr_sched=False, max_epochs=2)


def _batches(rng):
    """Two streaming-style batches (6 rows, then a final 5) and a windowed
    one, as lists / tuples of arrays."""
    out = []
    for rows, t in ((6, 10), (5, 12)):
        out.append([(rng.normal(size=(rows, t, 4)).astype(np.float32),
                     np.full((rows,), t, np.int32)),
                    (rng.normal(size=(rows, t, 2)).astype(np.float32),
                     np.full((rows,), t, np.int32))])
    out.append(tuple(rng.normal(size=(7, 3, k)).astype(np.float32)
                     for k in (81, 18, 18)))
    return out


def _flat(batch):
    if isinstance(batch, (list, tuple)):
        return [y for x in batch for y in _flat(x)]
    return [np.asarray(batch)]


@pytest.mark.parametrize("pc", [2, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_host_row_shard_matches_jax(pc, as_tensor):
    batches = _batches(np.random.default_rng(pc))
    tiny = [[(np.zeros((pc - 1, 4, 2), np.float32),
              np.ones((pc - 1,), np.int32))]]
    for pi in range(pc):
        want = list(JaxHostRowShard(batches + tiny, pi, pc))
        ours_in = batches + tiny
        if as_tensor:  # device-collated fbank batches are tensors
            ours_in = [[(torch.from_numpy(x), n) for x, n in b]
                       if isinstance(b, list) else b for b in ours_in]
        got = list(HostRowShard(ours_in, pi, pc))
        assert len(got) == len(want) == len(batches)
        assert len(HostRowShard(ours_in, pi, pc)) == len(ours_in)
        for g, w in zip(got, want):
            assert type(g) is type(w)
            for a, b in zip(_flat(g), _flat(w)):
                np.testing.assert_array_equal(a, b)


def test_pad_and_shard_batch_match_jax():
    batch = _batches(np.random.default_rng(0))[1]  # 5 rows
    want = jmesh.pad_batch_to_devices(batch, 8, -100.0)
    got = mesh.pad_batch_to_devices(batch, 8, -100.0)
    for a, b in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tgot = mesh.pad_batch_to_devices(
        [(torch.from_numpy(x), n) for x, n in batch], 8, -100.0)
    for a, b in zip(_flat(tgot), _flat(want)):
        np.testing.assert_array_equal(a, b)
    sharded = jmesh.shard_batch(jmesh.make_mesh(), want)
    for r in range(8):
        ours = mesh.shard_batch(mesh.DataMesh(data=8, rank=r), got)
        for a, b in zip(_flat(ours), jax_leaves(sharded)):
            shard = next(s for s in b.addressable_shards
                         if s.device == b.sharding.mesh.devices.flat[r])
            np.testing.assert_array_equal(a, np.asarray(shard.data))
    with pytest.raises(ValueError, match="pad_batch_to_devices"):
        mesh.shard_batch(mesh.DataMesh(data=2, rank=0), batch)


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_meshes_a_process_group_cannot_be_raise():
    one = mesh.make_mesh()
    assert (one.shape, one.rank, one.world_size) == (
        {"data": 1, "model": 1}, 0, 1)
    assert mesh.make_mesh_2d(1, 1) == one
    with pytest.raises(ValueError, match="torchrun"):
        mesh.make_mesh(2)
    with pytest.raises(NotImplementedError, match="queue A, item 10"):
        mesh.make_mesh_2d(1, 2)
    with pytest.raises(ValueError, match="outside"):
        mesh.DataMesh(data=2, rank=2)
    pm = Metaformer(MF_CFG, device="cpu")
    opt = optim.build_optimizer(pm.parameters(), OPTIM)
    with pytest.raises(TypeError, match="DataMesh"):
        harness.Trainer(pm, None, None, opt, OPTIM, mesh=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="process group of 1"):
        harness.Trainer(pm, None, None, opt, OPTIM,
                        mesh=mesh.DataMesh(data=2, rank=1), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        distributed.data_parallel(pm)


def test_stage_keeps_rows_without_a_process_group(tmp_path):
    """No padding: a process feeds one device, so its rows divide (JAX
    pads to a multiple of the devices a process feeds). Strided rows (a
    ``HostRowShard`` of a tensor) stage contiguous; without a process
    group the model is not wrapped and this process is the writer."""
    pm = Metaformer(MF_CFG, device="cpu")
    opt = optim.build_optimizer(pm.parameters(), OPTIM)
    trainer = harness.Trainer(pm, None, None, opt, OPTIM,
                              log_dir=str(tmp_path), device="cpu")
    assert trainer.mesh == mesh.make_mesh()
    assert distributed.data_parallel_of(pm) is None and trainer.primary
    assert ckpt.is_primary()
    rows = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    local = next(iter(HostRowShard([[(rows, np.full(5, 3))]], 1, 2)))
    assert not local[0][0].is_contiguous()
    staged = trainer._stage(local)
    assert staged[0][0].is_contiguous()
    np.testing.assert_array_equal(staged[0][0].numpy(), rows[1:4:2].numpy())
    np.testing.assert_array_equal(staged[0][1], [3, 3])
    windowed = tuple(np.ones((3, 2, k), np.float32) for k in (81, 18, 18))
    assert [x.shape[0] for x in trainer._stage(windowed)] == [3, 3, 3]
    trainer._log({"x": 1})
    assert (tmp_path / "metrics.jsonl").read_text() == '{"x": 1}\n'


def test_run_forward_without_a_wrapper_calls_the_model():
    pm = torch.nn.Linear(2, 3)
    x = torch.ones(4, 2)
    got = distributed.run_forward(pm, lambda m, a: m(a) * 2, x)
    torch.testing.assert_close(got, pm(x) * 2)


class _Joined(Exception):
    """Raised by the patched ``init_process_group``: the group it was
    asked for, without joining one."""


@pytest.fixture
def cuda_visible(monkeypatch):
    """CUDA reported available on this CPU host; ``init_process_group``
    raises ``_Joined(backend)``; ``set_device`` records its card."""
    cards = []

    def join(backend, **kw):
        raise _Joined(backend)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.distributed, "init_process_group", join)
    monkeypatch.setenv("LOCAL_RANK", "1")
    return cards


@pytest.mark.parametrize("device, backend, cards", [
    ("cpu", "gloo", []), (None, "nccl", [1]), ("cuda", "nccl", [1])])
def test_initialize_multihost_takes_the_device_backend(cuda_visible, device,
                                                       backend, cards):
    """A run on the CPU joins over gloo and sets no card, whether or not
    a card is visible (NCCL cannot reduce CPU tensors, and rank 1 has no
    card on a one-card host); a run on CUDA, named or by default, joins
    over NCCL on the card ``LOCAL_RANK``."""
    with pytest.raises(_Joined, match=backend):
        distributed.initialize_multihost("file:///nowhere", world_size=2,
                                         rank=1, device=device)
    assert cuda_visible == cards


def test_cli_joins_over_gloo_for_a_cpu_run_with_cuda_visible(cuda_visible,
                                                           monkeypatch):
    """``torchrun ... train.cli ... device=cpu`` on a host with a card:
    the CLI reads ``device`` before it joins the group, so it joins over
    gloo and takes no card."""
    from multimodalreactiongeneration_tpu_torch.train import cli
    from tests.test_torch_port_cli import SMALL, YAML

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(_Joined, match="gloo"):
        cli.main(["--config", YAML, *SMALL])
    assert cuda_visible == []


def test_rank_device(monkeypatch):
    """A named device with an index, or the CPU, as named; under a process
    group ``cuda`` or no device is this rank's current card; without a
    group ``resolve_device``'s."""
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.rank_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert distributed.rank_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for named in (None, "cuda"):
        assert distributed.rank_device(named) == torch.device("cuda", 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.rank_device("cuda:0") == torch.device("cuda", 0)


@pytest.fixture(scope="module")
def step_readings():
    return dryrun.step_readings(2, dryrun.VARIANTS, timeout=300.0)


@pytest.mark.parametrize("variant", dryrun.VARIANTS)
def test_two_process_train_steps_match_one_process(step_readings, variant):
    r = step_readings[variant]
    assert r["rows"] == [8, 4, 4]
    assert not r["single_ddp"]
    for losses in [r["single"]] + r["ranks"]:
        assert len(losses) == 2 and np.isfinite(losses).all()
    dryrun.check_steps(r, loss_tol=1e-4, param_tol=1e-5, rank_tol=1e-6)


def test_timed_step_readings_launch_one_after_the_other(monkeypatch):
    """``timed``: the single process's launch has ended before the ranks'
    starts, and the readings are the untimed ones'."""
    events = []
    launch = dryrun.launch_multihost

    def traced(n, *args, **kw):
        events.append(("start", n))
        try:
            return launch(n, *args, **kw)
        finally:
            events.append(("end", n))

    monkeypatch.setattr(dryrun, "launch_multihost", traced)
    r = dryrun.step_readings(2, ("f32",), timeout=300.0, timed=True)["f32"]
    assert events == [("start", 1), ("end", 1), ("start", 2), ("end", 2)]
    assert r["rows"] == [8, 4, 4]
    dryrun.check_steps(r, loss_tol=1e-4, param_tol=1e-5, rank_tol=1e-6)


def test_two_process_fit_matches_one_process():
    """The history and checkpoints as one process's; rank 0's record
    counts the global batch's frames (summed over the ranks), as one
    process's does."""
    r = dryrun.verify_multihost_fit(2, timeout=300.0, tol=1e-4)
    assert r["ckpts"][0] == ["V1-%.6f" % r["single"][1], "last"]
    assert r["frames"][0] == r["frames"][1] and r["frames"][0][0] > 0


def test_cli_trains_on_two_processes_and_rank_zero_writes(tmp_path):
    """``train.cli`` as ``torchrun --nproc_per_node 2`` starts it (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT), over gloo on the
    CPU, with ``trainer.mesh_shape=[2, 1]``: both ranks finish; rank 0
    alone wrote the log, ``metrics.jsonl`` (one record per check and
    epoch, not one per rank) and the checkpoints."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from tests.fixtures import make_synthetic_corpus
    from tests.test_torch_port_cli import SMALL, YAML

    corpus = make_synthetic_corpus(str(tmp_path / "corpus"), n_sessions=1,
                                   seconds=90.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "multimodalreactiongeneration_tpu_torch.train."
           "cli", "--config", os.path.abspath(YAML), "name=dp",
           f"data_dir={corpus}", "ckpt_path=ck", "log_dir=log", *SMALL,
           "max_epochs=1", "trainer.mesh_shape=[2, 1]"]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                   PYTHONPATH=root + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            cmd, cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
            stderr=open(tmp_path / f"err{r}.txt", "w")))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0, 0], (tmp_path / "err0.txt").read_text()[-3000:]
    with open(tmp_path / "log" / "metrics.jsonl", encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    assert [("val_check" in x) for x in lines] == [True, True, False]
    assert np.isfinite(lines[-1]["train_loss"])
    logs = [n for n in os.listdir(tmp_path / "log") if n.startswith("main")]
    assert len(logs) == 1
    text = (tmp_path / "log" / logs[0]).read_text()
    assert "data parallel: process 0 of 2" in text
    assert "last" in os.listdir(tmp_path / "ck" / "dp")
