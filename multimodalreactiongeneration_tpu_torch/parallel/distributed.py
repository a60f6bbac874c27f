"""Data-parallel set-up: one process per GPU under ``torchrun``.

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
  * ``world_size``, ``rank``, ``rank_device``, ``barrier``,
    ``rank_zero_first`` and the losses' reductions ``all_reduce_mean`` /
    ``all_reduce_sum``: each a no-op, or the single process's value,
    without a process group.
  * ``data_parallel``: broadcast the model's parameters from rank 0 and
    wrap it in ``DistributedDataParallel``; ``run_forward`` runs a train
    step's forward through that wrapper, so its backward averages the
    gradients.

JAX functions with no counterpart here: ``global_data_mesh`` is
``parallel/mesh.py make_mesh()`` (the data axis over every rank), and
``host_local_batch_to_global`` (``make_array_from_process_local_data``)
has none: no rank assembles a global array; each keeps its own rows, and
the only cross-rank values are the gradients (DDP's all-reduce) and the
logged losses and metrics (``train/harness.py Trainer``).

The DDP module is a thin runner, ``forward(fn, *args) = fn(model,
*args)``, not the model itself: a train step's forward is one call of
its step function's body (the model on bf16 copies of its parameters
through ``torch.func.functional_call``, under ``torch.utils.checkpoint``
with remat, or a whole scheduled-sampling rollout of many model calls),
and DDP needs exactly one forward of its own per backward, with
recomputation inside it, not around it. The model stays the module the
step functions, the checkpoints and the optimizer see; the wrapper is
kept on it (``data_parallel_of``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

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


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (itself without a process group)."""
    if world_size() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks."""
    return all_reduce_sum(x) / world_size()


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
