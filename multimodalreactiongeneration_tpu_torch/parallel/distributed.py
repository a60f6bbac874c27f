"""Data parallel and parameter sharding: one process per GPU (torchrun).

Counterpart of ``multimodalreactiongeneration_tpu/parallel/distributed.py``.
The reference trains with Lightning DDP, one process per GPU over NCCL;
the JAX package runs one process per TPU host and a global 'data' mesh
over every chip. The port goes back to the reference's shape: one
process per card joined in a ``torch.distributed`` process group (NCCL
on CUDA, gloo on the CPU), every rank holding the whole model and its
rows of each global batch (``data/dataset.py HostRowShard``), the
gradients averaged over ranks by ``DistributedDataParallel`` in the
backward.

  * ``initialize_multihost``: join the process group (a no-op for one
    process), from the arguments or the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
  * ``world_size``, ``rank``, ``rank_device``, ``barrier`` and
    ``rank_zero_first``: each a no-op, or the single process's value,
    without a process group.
  * ``data_parallel``: broadcast the model's parameters from rank 0 and
    wrap it in ``DistributedDataParallel``; ``run_forward`` runs a train
    step's forward through that wrapper, so its backward averages the
    gradients.
  * ``shard_parameters`` (a mesh with a 'model' axis above 1,
    ``parallel/mesh.py``): each rank keeps only its slice of every
    parameter that JAX's ``param_sharding`` splits (and the optimizer
    keeps state of that layout); ``gathered`` makes them whole for a step,
    and after the backward averages the gradients over the data axis and
    keeps this rank's slice of each.
  * the collectives under it and under the logged losses: ``axis_sum``
    (a sum over a mesh axis), ``all_gather_rows`` (every rank's rows, in
    rank order), ``shard_of`` (this rank's slice of a whole tensor) and
    ``gather_shard`` (the whole tensor from every rank's slice); each the
    identity over an axis of one rank.

JAX functions with no counterpart here: ``global_data_mesh`` is
``parallel/mesh.py make_mesh()`` (the data axis over every rank), and
``host_local_batch_to_global`` (``make_array_from_process_local_data``)
has none: no rank assembles a global array; each keeps its own rows, and
the only cross-rank values are the gradients (DDP's all-reduce, or the
sharded layout's), sharded parameters, the logged losses and metrics
(``train/harness.py Trainer``) and a mesh serving pool's outputs
(``infer/serving.py``).

The DDP module is a thin runner, ``forward(fn, *args) = fn(model,
*args)``, not the model itself: a train step's forward is one call of
its step function's body (the model on bf16 copies of its parameters
through ``torch.func.functional_call``, under ``torch.utils.checkpoint``
with remat, or a whole scheduled-sampling rollout of many model calls),
and DDP needs exactly one forward of its own per backward, with
recomputation inside it, not around it. The model stays the module the
step functions, the checkpoints and the optimizer see; the wrapper is
kept on it (``data_parallel_of``).

Sharded parameters (JAX's 'model' axis) are a ZeRO-3-like layout: the
storage is split by JAX's rule, and a step computes on whole weights,
gathered over the model axis as it starts, as JAX keeps the recurrent
kernels' gate matrices whole (K3-K7 take whole weights), and the step's
device time is theirs (PERF.md). Between steps a sharded parameter's
``data`` IS its slice, so the optimizer, which holds the same parameter
objects, makes its state (AdamW's moments, ``MultiSteps``' accumulators)
at the slice's size; a step swaps the gathered whole tensor in and back
out. One flat all-gather brings every slice of a step, one flat
all-reduce averages every gradient over the data axis. The ranks of one
model group see the same rows, so their replicated parameters' gradients,
and updates, are the same.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from multimodalreactiongeneration_tpu_torch import resolve_device


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join the process group; a no-op for a single process.

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK`` (1 and 0 without them), ``init_method`` to ``env://``
    (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``; ``tcp://host:port`` or
    ``file://path`` otherwise). ``backend`` defaults to the one of the
    device the run trains on, ``device`` (the port's default, CUDA, where
    none is named): NCCL for CUDA, gloo for the CPU (NCCL cannot reduce
    CPU tensors). Under NCCL each rank takes the card ``LOCAL_RANK`` (its
    rank without it) as its current device (``rank_device``)."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return
    if dist.is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        kind = torch.device(device).type if device is not None else "cuda"
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """The device this rank trains on: ``device`` where it names one with
    an index or another type than CUDA; else this rank's card (the
    current one, which ``initialize_multihost`` set to ``LOCAL_RANK``
    under NCCL), or ``cuda:0`` without a process group
    (``resolve_device``)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if world_size() == 1:
        return resolve_device(device)
    return torch.device("cuda", torch.cuda.current_device())


class _StepRunner(torch.nn.Module):
    """DDP's module: runs ``fn(model, *args)``; its parameters are the
    model's."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn: Callable, *args):
        return fn(self.model, *args)


_ATTR = "_data_parallel"


def data_parallel(model: torch.nn.Module):
    """Wrap ``model`` for data-parallel training in the process group:
    ``DistributedDataParallel`` broadcasts its parameters from rank 0 as
    it is made, so every rank starts from rank 0's. Returns the wrapper,
    also kept on the model for ``run_forward`` (the model's state_dict
    and parameters are unchanged). ``find_unused_parameters``: a step may
    leave parameters without a gradient (a path the config does not
    run), and a rank must not wait on them."""
    from torch.nn.parallel import DistributedDataParallel

    if not dist.is_initialized():
        raise RuntimeError(
            "data_parallel needs a process group: call initialize_multihost "
            "(or run under torchrun) first")
    ddp = data_parallel_of(model)
    if ddp is None:
        ddp = DistributedDataParallel(_StepRunner(model),
                                      find_unused_parameters=True)
        # a plain attribute, not a submodule: the model's state_dict and
        # parameters stay its own
        object.__setattr__(model, _ATTR, ddp)
    return ddp


def data_parallel_of(model: torch.nn.Module):
    """The ``data_parallel`` wrapper of ``model``, or None."""
    return model.__dict__.get(_ATTR)


def run_forward(model: torch.nn.Module, fn: Callable, *args):
    """``fn(model, *args)``: the forward of a train step. Where the model
    is wrapped (``data_parallel``) and a gradient is recorded, it runs as
    the DDP wrapper's forward, so the backward that follows averages the
    parameters' gradients over the ranks."""
    ddp = data_parallel_of(model)
    if ddp is None or not torch.is_grad_enabled():
        return fn(model, *args)
    return ddp(fn, *args)


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first():
    """Rank 0 runs the block before the others do (they wait for it): a
    cache that rank 0 writes (the corpus manifests under ./data) is read,
    not rewritten, by the rest."""
    if rank() != 0:
        barrier()
    yield
    if rank() == 0:
        barrier()


# ---------------------------------------------------------------------------
# collectives over a mesh axis (a group; None: an axis of one rank)
# ---------------------------------------------------------------------------

def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dim 0, in the
    group's rank order (``x`` itself without a group). Every rank's ``x``
    has the same shape."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def axis_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (itself without a group)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def shard_of(x: torch.Tensor, dim: int, index: int,
             parts: int) -> torch.Tensor:
    """The ``index``-th of ``parts`` equal contiguous slices of ``x`` along
    ``dim``, an owned contiguous tensor."""
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n).contiguous().clone()


def gather_shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of which every rank of ``group`` holds the slice
    ``x`` along ``dim`` (``shard_of``'s inverse)."""
    if group is None:
        return x
    rows = all_gather_rows(x.reshape(1, -1), group)
    return torch.cat([r.view(x.shape) for r in rows], dim=dim)


# ---------------------------------------------------------------------------
# parameters sharded over the mesh's 'model' axis
# ---------------------------------------------------------------------------

class ParamShards:
    """The sharded layout of a model's parameters (``shard_parameters``):
    ``dims`` maps each parameter's name to its split dim or None. Between
    steps a split parameter's ``data`` is this rank's slice; inside
    ``gathered`` it is the whole tensor."""

    def __init__(self, model: torch.nn.Module, mesh,
                 dims: Dict[str, Optional[int]]):
        self.mesh = mesh
        self.params = [(p, dims[name]) for name, p in model.named_parameters()]
        self.split = [(p, d) for p, d in self.params if d is not None]
        self._dim = {id(p): d for p, d in self.split}
        self._whole = {id(p): p.shape for p, _ in self.split}
        # while gathered: the slices the whole tensors stand in for
        self._slices: Optional[List[torch.Tensor]] = None

    def whole_shape(self, p: torch.Tensor) -> torch.Size:
        """The shape of split parameter ``p`` whole."""
        return self._whole[id(p)]

    def shard(self) -> None:
        """Keep this rank's slice of every split parameter."""
        m = self.mesh
        for p, d in self.split:
            p.data = shard_of(p.data, d, m.model_rank, m.model)

    def slice_state(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole per-element state tensor ``t`` of
        parameter ``p`` (an optimizer moment); ``t`` itself otherwise."""
        d = self._dim.get(id(p))
        if d is None or t.shape != self._whole[id(p)]:
            return t
        return shard_of(t, d, self.mesh.model_rank, self.mesh.model)

    def whole_state(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a per-element state tensor ``t`` of ``p``
        held at the slice's size (every rank of the model group calls it,
        in the same order); ``t`` itself otherwise."""
        d = self._dim.get(id(p))
        if d is None or t.shape != p.shape:
            return t
        return gather_shard(t, d, self.mesh.group("model"))

    def gather(self) -> None:
        """Swap every split parameter's slice for the whole tensor: one
        all-gather of every slice, flat, over the model axis."""
        slices = [p.data for p, _ in self.split]
        self._slices = slices
        if not slices:
            return
        flat = torch.cat([s.reshape(-1) for s in slices])
        rows = all_gather_rows(flat.unsqueeze(0),
                               self.mesh.group("model"))
        offset = 0
        for (p, d), s in zip(self.split, slices):
            n = s.numel()
            p.data = torch.cat([r[offset:offset + n].view(s.shape)
                                for r in rows], dim=d)
            offset += n

    def release(self, grads: bool) -> None:
        """Swap the slices back in. With ``grads``: the gradients the
        backward left on the whole parameters are averaged over the data
        axis (one all-reduce, flat), and each split parameter keeps this
        rank's slice of its gradient."""
        m = self.mesh
        kept = []
        if grads:
            for p, d in self.params:
                if p.grad is None:
                    continue
                g = (p.grad if d is None
                     else shard_of(p.grad, d, m.model_rank, m.model))
                kept.append((p, g))
            group = m.group("data")
            if kept and group is not None:
                flat = torch.cat([g.reshape(-1) for _, g in kept])
                dist.all_reduce(flat, group=group)
                flat /= m.data
                offset = 0
                for i, (p, g) in enumerate(kept):
                    kept[i] = (p, flat[offset:offset + g.numel()].view(
                        g.shape))
                    offset += g.numel()
        for (p, _), s in zip(self.split, self._slices):
            if p.grad is not None and p.grad.shape != s.shape:
                p.grad = None  # whole, not reduced: the block raised
            p.data = s
        for p, g in kept:
            p.grad = g
        self._slices = None


_SHARDS = "_param_shards"


def shard_parameters(model: torch.nn.Module, mesh,
                     dims: Dict[str, Optional[int]]) -> ParamShards:
    """Lay ``model``'s parameters out over ``mesh``'s 'model' axis:
    broadcast them from rank 0 (every rank starts from rank 0's, as
    ``data_parallel`` does), then keep this rank's slice of each parameter
    ``dims`` splits (``parallel/mesh.py param_sharding``). Returns the
    layout, also kept on the model (``param_shards``); slice the
    optimizer's state with its ``slice_state`` (``train/optim.py
    map_param_state``)."""
    if not dist.is_initialized() or world_size() != mesh.world_size:
        raise RuntimeError(
            f"a {mesh.data}x{mesh.model} mesh needs a process group of "
            f"{mesh.world_size}: call initialize_multihost (or run under "
            "torchrun) first")
    if data_parallel_of(model) is not None:
        raise RuntimeError("the model is already wrapped for data parallel")
    shards = param_shards(model)
    if shards is not None:
        return shards
    with torch.no_grad():
        params = list(model.parameters())
        flat = torch.cat([p.data.reshape(-1) for p in params])
        dist.broadcast(flat, 0)
        offset = 0
        for p in params:
            p.data.copy_(flat[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
    shards = ParamShards(model, mesh, dims)
    shards.shard()
    object.__setattr__(model, _SHARDS, shards)
    return shards


def param_shards(model: torch.nn.Module) -> Optional[ParamShards]:
    """The ``shard_parameters`` layout of ``model``, or None."""
    return model.__dict__.get(_SHARDS)


@contextlib.contextmanager
def gathered(model: torch.nn.Module, grads: bool = False):
    """Inside the block ``model``'s sharded parameters are whole (a no-op
    for a model that ``shard_parameters`` did not lay out, and inside an
    enclosing block). With ``grads`` the block is a train step's forward
    and backward: on leaving it the gradients are averaged over the data
    axis and sliced to this rank's (``ParamShards.release``), ready for
    the optimizer's step."""
    shards = param_shards(model)
    if shards is None or shards._slices is not None:
        yield
        return
    shards.gather()
    ok = False
    try:
        yield
        ok = True
    finally:
        shards.release(grads and ok)
