"""The data-parallel mesh: the process group as a 'data' axis.

Counterpart of ``multimodalreactiongeneration_tpu/parallel/mesh.py``. The
JAX package lays its devices out as a ``jax.sharding.Mesh`` with the batch
split over a 'data' axis and the parameters replicated (or, with a
'model' axis, sharded by ``param_sharding``); XLA inserts the gradient
all-reduce. In the port one process drives one card, so the 'data' axis
is the process group (``data`` = world size, one row shard per rank),
the parameters are replicated by ``DistributedDataParallel``
(``parallel/distributed.py``), and the all-reduce is DDP's.

  * ``make_mesh`` / ``make_mesh_2d``: the ``DataMesh`` of the process
    group (JAX's ``global_data_mesh`` too: the mesh over every rank). A
    'model' axis above 1 (JAX's ``param_sharding``: Dense kernels split
    over cards) raises NotImplementedError, ROADMAP queue A, item 10.
  * ``shard_batch``: a rank's rows of a global batch, the contiguous
    block that ``NamedSharding(mesh, P('data'))`` gives device ``rank``.
  * ``pad_batch_to_devices``: rows padded to a multiple of the ranks with
    the -100 sentinel (masked out of the loss numerator).

Nothing in the port stages through ``shard_batch`` or
``pad_batch_to_devices``: they exist for parity with JAX's (held to them
by the tests), for code that splits one global batch itself. The loaders
take a rank's rows with ``data/dataset.py HostRowShard``, and whether a
model trains data-parallel is the process group's to say, not the
mesh's: the ``DataMesh`` a ``Trainer`` or ``trainer.mesh_shape`` names is
only checked against the group.

No counterpart: ``batch_sharding`` and ``replicated`` (placements of
one array over many devices; a rank holds its rows and a whole replica)
and ``param_sharding`` (queue A, item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.parallel import distributed

PARAM_SHARDING = ("sharding parameters over a 'model' mesh axis (JAX "
                  "parallel/mesh.py param_sharding) is not ported: ROADMAP "
                  "queue A, item 10")


@dataclass(frozen=True)
class DataMesh:
    """The process group as a ('data', 'model') mesh: ``data`` ranks, one
    card each, and a 'model' axis of 1; ``rank`` is this process's place
    on the data axis."""

    data: int = 1
    rank: int = 0

    def __post_init__(self):
        if not 0 <= self.rank < self.data:
            raise ValueError(f"rank {self.rank} outside a data axis of "
                             f"{self.data}")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": 1}

    @property
    def world_size(self) -> int:
        return self.data


def make_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """The data axis over the process group (every rank without
    ``n_devices``). ``n_devices`` must be the world size: one process
    drives one card, so a process cannot hold a sub-mesh."""
    world = distributed.world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a data axis of {n_devices} needs {n_devices} processes (one "
            f"per card, torchrun --nproc_per_node); the group has {world}")
    return DataMesh(data=world, rank=distributed.rank())


def make_mesh_2d(data: int, model: int) -> DataMesh:
    """``trainer.mesh_shape: [data, model]``: ``data`` the world size and
    ``model`` 1; a 'model' axis above 1 raises (``PARAM_SHARDING``)."""
    if model != 1:
        raise NotImplementedError(PARAM_SHARDING)
    return make_mesh(data)


def _map(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, x) for x in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of a global batch (numpy arrays or tensors, in
    nested lists / tuples / dicts): the ``rank``-th of ``data`` equal
    contiguous blocks. Every leaf's leading dim must divide ``data``
    (``pad_batch_to_devices``)."""
    def rows(x):
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"{b} rows do not divide a data axis of "
                             f"{mesh.data}: pad_batch_to_devices first")
        n = b // mesh.data
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    return _map(rows, batch)


def pad_batch_to_devices(batch, n_devices: int, pad_value: float):
    """Pad the batch dim so it divides ``n_devices`` (masked rows
    contribute nothing to the loss thanks to the -100 loss mask)."""
    def pad(x):
        b = x.shape[0]
        rem = (-b) % n_devices
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            fill = x.new_full((rem,) + tuple(x.shape[1:]), pad_value)
            return torch.cat([x, fill], dim=0)
        x = np.asarray(x)
        fill = np.full((rem,) + x.shape[1:], pad_value, x.dtype)
        return np.concatenate([x, fill], axis=0)

    return _map(pad, batch)
