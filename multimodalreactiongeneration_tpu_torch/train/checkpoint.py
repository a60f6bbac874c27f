"""Checkpointing: top-k monitors, ``last``, and restore, on ``torch.save``.

Counterpart of ``multimodalreactiongeneration_tpu/train/checkpoint.py``
(orbax there). Reference semantics: Lightning ModelCheckpoint keeps top-k
on a monitored loss plus a ``last`` checkpoint (reference
lstmformer/trainer.py:33-57, the same for lstm_with_sampling). Here,
for any ``nn.Module`` (the Metaformer and LSTMwithSample alike):

  * ``TopKCheckpointer``: one file per checkpoint, named as in the JAX
    package, ``{monitor}{epoch}-{loss:.6f}`` (V val_loss, T train_loss,
    G genrt_loss), plus ``last``; a resumed run seeds its top-k from the
    files already in the directory and prunes beyond k;
  * a payload is ``{"params": model state_dict, "epoch": int}`` plus
    ``"opt"`` (the optimizer's state_dict) where optimizer state is
    saved: always in ``last``, in the top-k files only with
    ``save_opt_state="all"``; under gradient accumulation it is
    ``train/optim.py MultiSteps``' state (the inner optimizer's, the
    running mean of the micro-batches' gradients and the micro-step
    count, what the MultiSteps ``opt_state`` of a JAX checkpoint holds),
    so a run resumed mid-accumulation goes on as the unbroken run would;
  * ``use_async``: the payload is copied to host memory on the calling
    thread (a snapshot the next step cannot touch), and ``torch.save``
    writes it on a background thread, at most one in flight per monitor;
    the bytes on disk equal a synchronous save's.
  * data parallel: a save is local to the process that calls it (JAX
    scopes its orbax checkpointer to the calling rank for the same
    reason); ``is_primary`` names the one process that saves, rank 0, so
    ranks never write the same path at once. Parameters sharded over a
    'model' axis are saved whole (``HostSnapshot``), and a run resumed on
    a mesh loads them whole before its ``Trainer`` keeps each rank's
    slice.

``import_torch_state_dict`` maps a reference (PyTorch-Lightning)
state_dict onto the port's names (JAX ``import_torch_state_dict``);
``models/torch_import.py`` holds the per-model name tables.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.parallel import distributed
from multimodalreactiongeneration_tpu_torch.train.optim import map_state_dict


def _to_host(tree):
    """An owned host copy of a (nested) state dict."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class HostSnapshot:
    """One host copy of the model's (and optionally the optimizer's)
    state, shared by the monitors that save at the same check. Parameters
    sharded over a mesh's 'model' axis (``parallel/distributed.py
    shard_parameters``) and their optimizer state are gathered whole, so
    every rank of the mesh makes the snapshot (the gathers are
    collectives), and a checkpoint loads ``strict=True`` into one
    process's model."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None):
        with distributed.gathered(model):
            self.tree = {"params": _to_host(model.state_dict())}
        if optimizer is not None:
            state = optimizer.state_dict()
            shards = distributed.param_shards(model)
            if shards is not None:
                state = map_state_dict(optimizer, state, shards.whole_state)
            self.tree["opt"] = _to_host(state)


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints: rank 0 of the
    process group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


class TopKCheckpointer:
    def __init__(self, directory: str, top_k: int = 5, monitor: str = "V",
                 use_async: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._thread_exc: Optional[BaseException] = None
        self._saved: List[Tuple[float, str]] = []  # (loss, path)
        # seed from checkpoints already on disk so a resumed run compares
        # against and prunes the previous run's top-k
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith(self.monitor):
                continue
            try:
                loss = float(name[len(self.monitor):].split("-", 1)[1])
            except (IndexError, ValueError):
                continue
            self._saved.append((loss, os.path.join(self.directory, name)))
        self._saved.sort()
        for _, stale in self._saved[self.top_k:]:
            _remove(stale)
        del self._saved[self.top_k:]

    def wait(self) -> None:
        """Block until the in-flight background save is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            exc, self._thread_exc = self._thread_exc, None
            if exc is not None:
                raise exc

    def _save(self, path: str, snap: HostSnapshot, epoch: int) -> None:
        # one save in flight: pruning never races an unfinished write
        self.wait()
        _remove(path)
        payload = dict(snap.tree, epoch=epoch)
        if not self.use_async:
            torch.save(payload, path)
            return

        def run():
            try:
                torch.save(payload, path)
            except Exception as exc:  # noqa: BLE001 - raised by wait()
                self._thread_exc = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def maybe_save(self, snap: HostSnapshot, epoch: int, loss: float) -> bool:
        path = os.path.join(self.directory, f"{self.monitor}{epoch}-{loss:.6f}")
        if len(self._saved) < self.top_k:
            self._save(path, snap, epoch)
            self._saved.append((loss, path))
            self._saved.sort()
            return True
        worst_loss, worst_path = self._saved[-1]
        if loss < worst_loss:
            self._save(path, snap, epoch)
            if worst_path != path:
                _remove(worst_path)
            self._saved[-1] = (loss, path)
            self._saved.sort()
            return True
        return False

    def save_last(self, snap: HostSnapshot, epoch: int) -> None:
        self._save(os.path.join(self.directory, "last"), snap, epoch)

    def best_path(self) -> Optional[str]:
        return self._saved[0][1] if self._saved else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_opt_state(payload: Dict[str, Any], optimizer) -> bool:
    """Load the payload's optimizer state into ``optimizer``, a torch
    optimizer or a ``MultiSteps`` (its tensors move to the parameters'
    device); False if the checkpoint holds none."""
    if payload.get("opt") is None:
        return False
    optimizer.load_state_dict(payload["opt"])
    return True


# ---------------------------------------------------------------------------
# reference torch state_dict -> the port's state_dict
# ---------------------------------------------------------------------------

_RNN_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_UNPACKED_QKV = ("q_proj_weight", "k_proj_weight", "v_proj_weight")


def _f32(value) -> torch.Tensor:
    """An owned, contiguous float32 CPU tensor of ``value``."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def import_torch_state_dict(
    state_dict: Mapping[str, Any],
    name_map: Dict[str, str],
) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a reference one.

    ``name_map``: reference prefix -> the JAX package's flax path prefix
    (``models/torch_import.py``), whose "/" become the port's "."; the
    longest prefix that ends on a name boundary wins. Per leaf:
      * Linear and LayerNorm ``weight`` / ``bias`` keep name and layout
        (the port's modules hold torch's layout, so the JAX importer's
        kernel transpose and ``models/weights.py``'s transpose back
        cancel);
      * LSTM / GRU ``weight_ih_l*`` / ``bias_*`` and the unpacked MHA
        ``q/k/v_proj_weight`` are copied verbatim;
      * MHA ``in_proj_weight`` / ``in_proj_bias`` split into q, k and v
        thirds; ``out_proj.weight`` / ``.bias`` become ``out_proj_*``.
    A name no prefix covers on a name boundary, or a covered name whose
    leaf is of no known kind (a registered buffer such as
    ``running_mean``), is skipped, as the JAX importer skips it;
    ``models/torch_import.py convert_checkpoint`` loads the result with
    ``strict=True``, so a parameter left out still fails there.
    """
    prefixes = sorted(name_map.items(), key=lambda x: -len(x[0]))
    out: Dict[str, torch.Tensor] = {}
    for tname, value in state_dict.items():
        hit = next(((p, m) for p, m in prefixes
                    if tname == p or tname.startswith(p + ".")), None)
        if hit is None:
            continue
        ours = hit[1].replace("/", ".")
        rest = tname[len(hit[0]):].lstrip(".")
        array = _f32(value)
        leaf = rest.rsplit(".", 1)[-1]
        if leaf in ("in_proj_weight", "in_proj_bias"):
            kind = leaf[len("in_proj_"):]
            for part, sub in zip("qkv", torch.chunk(array, 3, dim=0)):
                out[f"{ours}.{part}_proj_{kind}"] = sub.contiguous()
        elif rest.startswith(_RNN_LEAVES) or rest in _UNPACKED_QKV:
            out[f"{ours}.{rest}"] = array
        elif rest.endswith(("out_proj.weight", "out_proj.bias")):
            out[f"{ours}.out_proj_{leaf}"] = array
        elif leaf in ("weight", "bias"):
            out[f"{ours}.{rest}"] = array
    return out
