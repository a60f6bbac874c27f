"""The (data, model) mesh: the process group as a grid of ranks.

Counterpart of ``multimodalreactiongeneration_tpu/parallel/mesh.py``. The
JAX package lays its devices out as a ``jax.sharding.Mesh`` with the batch
split over a 'data' axis and the parameters replicated or, with a 'model'
axis above 1, sharded by ``param_sharding``; XLA inserts the gradient
all-reduce and the weight all-gathers. In the port one process drives one
card, so the mesh is the process group laid out as a grid: rank r sits at
(r // model, r % model), 'model' the minor axis (JAX's ``reshape(data,
model)``), and the mesh carries the sub-groups of its two axes.

  * ``make_mesh`` / ``make_mesh_2d``: the ``DataMesh`` of the process
    group (JAX's ``global_data_mesh`` too: the mesh over every rank);
    ``data x model`` must be the world size.
  * ``param_sharding``: JAX's rule on the port's parameters, each
    parameter's dim split over 'model' (or None: replicated). The port's
    names mirror the flax paths (``models/weights.py``), a Dense
    ``weight`` being the flax ``kernel`` transposed, so the rule reads each
    parameter as its flax leaf: the same four recurrent substrings keep a
    leaf replicated, the same stable ranking of dims by size picks the
    split, and the dim maps back through the transpose.
  * ``shard_batch``: a rank's rows of a global batch, the contiguous
    block that ``NamedSharding(mesh, P('data'))`` gives its place on the
    data axis.
  * ``pad_batch_to_devices``: rows padded to a multiple of the ranks with
    the -100 sentinel (masked out of the loss numerator).

How the mesh is used: with a 'model' axis of 1 the ``Trainer`` runs data
parallel under ``DistributedDataParallel``; above 1 it stores each
parameter and its optimizer state by ``param_sharding`` and gathers them
whole for a step (``parallel/distributed.py shard_parameters``). Rows are
split over 'data' only (``data/dataset.py HostRowShard`` at the mesh's
``data_rank``), as JAX's ``batch_sharding``: the ranks of one model group
see the same rows. ``infer/serving.py ServingEngine`` splits its slot
pool over 'data'.

Nothing in the port stages through ``shard_batch`` or
``pad_batch_to_devices``: they exist for parity with JAX's (held to them
by the tests), for code that splits one global batch itself.

No counterpart: ``batch_sharding`` and ``replicated`` (placements of
one array over many devices; a rank holds its rows, and its shard or a
whole replica of each parameter).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from multimodalreactiongeneration_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class DataMesh:
    """The process group as a ('data', 'model') grid: ``data x model``
    ranks, one card each; ``rank`` is this process's rank in the group, at
    (``data_rank``, ``model_rank``). ``data_group`` / ``model_group`` are
    the process groups of this rank's row and column of the grid (made by
    ``make_mesh_2d``; ``group`` resolves them)."""

    data: int = 1
    rank: int = 0
    model: int = 1
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"a {self.data}x{self.model} mesh")
        if not 0 <= self.rank < self.data * self.model:
            raise ValueError(f"rank {self.rank} outside a {self.data}x"
                             f"{self.model} mesh")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def world_size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        """This rank's place on the data axis (its block of rows)."""
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        """This rank's place on the model axis (its slice of a sharded
        parameter)."""
        return self.rank % self.model

    def group(self, axis: str):
        """The process group of this rank's ``axis`` ('data' or 'model'):
        None where the axis has one rank (a collective over it is the
        identity), the whole group where the axis spans it. An axis of
        more ranks without its group raises: nothing runs replicated in
        place of a collective."""
        size, group = ((self.data, self.data_group) if axis == "data"
                       else (self.model, self.model_group))
        if size == 1:
            return None
        if group is not None:
            return group
        if size == self.world_size and dist.is_initialized():
            return dist.group.WORLD
        raise RuntimeError(f"the {self.data}x{self.model} mesh has no process "
                           f"group for its '{axis}' axis: make it with "
                           "make_mesh_2d")


def make_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """The data axis over the process group (every rank without
    ``n_devices``). ``n_devices`` must be the world size: one process
    drives one card, so a process cannot hold a sub-mesh."""
    world = distributed.world_size()
    return make_mesh_2d(world if n_devices is None else n_devices, 1)


def make_mesh_2d(data: int, model: int) -> DataMesh:
    """``trainer.mesh_shape: [data, model]``: the process group as a
    ``data x model`` grid, 'model' the minor axis (rank r at (r // model,
    r % model)). ``data x model`` must be the world size. Every rank makes
    the grid's row and column groups (``torch.distributed.new_group``, the
    same calls in the same order on every rank) and keeps its own."""
    world = distributed.world_size()
    if data * model != world:
        raise ValueError(
            f"a {data}x{model} mesh needs {data * model} processes (one per "
            f"card, torchrun --nproc_per_node); the group has {world}")
    rank = distributed.rank()
    groups = {}
    for axis, size, members in (
            ("data", data, [[d * model + m for d in range(data)]
                            for m in range(model)]),
            ("model", model, [[d * model + m for m in range(model)]
                              for d in range(data)])):
        if 1 < size < world:
            for ranks in members:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return DataMesh(data=data, rank=rank, model=model,
                    data_group=groups.get("data"),
                    model_group=groups.get("model"))


_RNN_PARAM_MARKERS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def flax_leaf(name: str, shape: Tuple[int, ...]) -> Tuple[str, Tuple[int, ...],
                                                          bool]:
    """A port parameter as its flax leaf (``models/weights.py
    state_dict_from_jax`` read backwards): (the "/"-joined path, the
    shape, whether the port's layout is the flax one transposed). A 2-D
    ``weight`` is a Dense ``kernel`` (in, out); a 1-D one a LayerNorm
    ``scale``; every other leaf keeps its name and layout. The rename
    neither makes nor hides a recurrent marker: ``weight`` and ``kernel``
    end the path, and no marker is a suffix of either."""
    parts = name.split(".")
    if parts[-1] == "weight" and len(shape) == 2:
        parts[-1] = "kernel"
        return "/".join(parts), tuple(shape[::-1]), True
    if parts[-1] == "weight" and len(shape) == 1:
        parts[-1] = "scale"
    return "/".join(parts), tuple(shape), False


def param_sharding(
    model: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    mesh: DataMesh,
) -> Dict[str, Optional[int]]:
    """JAX's ``param_sharding`` on the port's parameters (a module's, or
    a name -> tensor mapping): for each name, the dim split over the
    mesh's 'model' axis, or None for a replicated parameter. As JAX: a
    leaf whose flax path holds ``weight_ih``, ``weight_hh``, ``bias_ih``
    or ``bias_hh`` stays replicated (the recurrent kernels take whole gate
    matrices); any other is split on its largest dim that the axis
    divides, dims ranked by ``sorted(range(ndim), key=-size)``, stable, so
    a tie goes to the lower flax dim (a square Dense kernel splits on its
    input dim: the port's dim 1)."""
    size = mesh.model
    items = (model.named_parameters() if isinstance(model, torch.nn.Module)
             else model.items())
    out: Dict[str, Optional[int]] = {}
    for name, p in items:
        path, shape, transposed = flax_leaf(name, tuple(p.shape))
        dim = None
        if not any(m in path for m in _RNN_PARAM_MARKERS):
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] >= size and shape[d] % size == 0:
                    dim = d
                    break
        out[name] = 1 - dim if transposed and dim is not None else dim
    return out


def _map(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, x) for x in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of a global batch (numpy arrays or tensors, in
    nested lists / tuples / dicts): the ``rank``-th of ``data`` equal
    contiguous blocks, ``rank`` the mesh's ``data_rank``. Every leaf's
    leading dim must divide ``data`` (``pad_batch_to_devices``)."""
    def rows(x):
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"{b} rows do not divide a data axis of "
                             f"{mesh.data}: pad_batch_to_devices first")
        n = b // mesh.data
        return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]

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
