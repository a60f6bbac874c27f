"""Training step functions.

Counterpart of ``streaming_step_fns``, ``scheduled_sampling_step_fn`` and
``windowed_step_fns`` in
``multimodalreactiongeneration_tpu/train/harness.py`` (reference
training_step / validation_step, lstmformer.py:357-424,
lstm_with_sample.py:278-337, simple_lstm.py:239-269).

``streaming_step_fns`` serves the two streaming models, the Metaformer
and LSTMwithSample (any module called as ``model(a_p, m_p, m_s, lead_a,
lead_mp, lead_ms) -> (y, state)``):

  * leading warmup frames are sliced off the prediction (y[:, lead:]);
  * prediction AND target are multiplied by the (target != -100) mask,
    then the loss takes the FULL-tensor mean: padding contributes zeros
    to the numerator and stays in the denominator;
  * the training loss scales the delta channels by sqrt(delta_loss_scale).

``windowed_step_fns`` serves SimpleLSTM on fixed windows (fbank, motion
context, one target frame): ``simple_lstm_loss`` in training; in
evaluation the plain MSE, with the all_static delta recompute; in both,
rows that are all -100 (filler) are zeroed out of prediction and target.

The step runs the model's modules eagerly; on CUDA the recurrences and
the attention go through their kernels: the Metaformer's encoder stacks,
self-motion LSTMs and integrators (``ops/mixer_stack.py``,
``ops/lstm_layer.py``, ``ops/rect_attention.py``; with GRU embeddings,
configs/lstmformer_gru.yaml, every encoder and self-motion block runs
``ops/gru.py``), LSTMwithSample's sampler stack and layered blocks
(``ops/lstm_stacked.py``, ``ops/lstm_layer.py``), SimpleLSTM's acoustic
LSTMs (``ops/lstm_layer.py``); under ``MRGEN_FUSED_DW=0`` the single-layer
LSTMs run ``ops/lstm_recurrence.py`` instead.

``compute_dtype=torch.bfloat16`` is JAX's mixed-precision step: each
train step runs the model on bf16 copies of every float parameter
(``torch.func.functional_call``, so autograd carries the gradients back
to the f32 parameters the optimizer keeps, as JAX's cast of the gradients
to f32 does) and on the six inputs cast to bf16 (JAX's ``_cast_tree``);
the loss and the metrics take the prediction in f32 against the f32
target. Inside the model every op takes the dtype JAX's promotion gives
it (``nn/basic.py``), so an f32 activation meeting bf16 weights computes
in f32; cuBLAS's bf16 products keep their partial sums in f32 for the
step (``bf16_sums_in_f32``). On the card LSTMwithSample's sampler and
layered blocks then run the bf16 modes of K9 and K7; the Metaformer's
encoder stacks the bf16 mode of K3/K4, its self-motion LSTMs K7's, and
its integrators K5/K6's bf16 mode where the query is bf16 (block 0) and
their f32 mode on the upcast keys and values where it is f32 (the later
blocks, whose queries come out of f32 attention contexts); with GRU
embeddings (configs/lstmformer_gru.yaml) every encoder and self-motion
block runs K10's bf16 mode (bf16 W_hh, whatever the dtype of its input).
Single-layer LSTMs on K8's route (``MRGEN_FUSED_DW=0``, or sizes not
multiples of 128) run K8's bf16 mode. Every trained model has its bf16
step. The eval step stays f32.

A train step's ``generator`` (the trainer's ``torch.Generator``) gives it
one seed, and the step's forward draws every dropout mask from it
(``nn.basic.dropout_rng``); a step given none draws no seed, so a model
with dropout in training raises there. ``remat=True`` runs the model call
under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of
``apply_fn``): the backward recomputes the forward, inside the same
``dropout_rng``, so with the same masks.

``scheduled_sampling_step_fn`` takes the loss on the AR rollout (the
bodies of ``infer/generate.py``'s generators, with gradients through
every step): each step feeds back the model's own prediction where
``uniform(length) < rate``, drawn from the trainer's generator; the
Metaformer's rollout runs the in-loop per-block layout with f32 rings, as
JAX's step pins it. On the card its warmup runs the encoder stacks'
training kernels (K3, K4) over the lead's audio, and lstm_with_sampling's
runs its sampler's stacked kernels (K9) under gradient.

``Trainer`` is the counterpart of the JAX package's fit loop: per-epoch
cosine LR, Lightning ``val_check_interval`` semantics
(a fraction of the train epoch, or every N steps when > 1) with
early-stop patience counted in validation checks, V/T/G top-k
checkpoints (T and G only with a generation eval) and ``last``, and the
same ``metrics.jsonl`` records. It stages both batch layouts: the
streaming (data, lengths) pairs and the windowed stacked arrays. Losses
and metrics stay on the device through the epoch and are read back once
at its end. With ``scheduled_max_epochs`` it passes the scheduled-sampling
step ``rate = epoch / scheduled_max_epochs`` and writes it into the check
and epoch records, as the JAX loop does. Gradient accumulation is the
optimizer's (``train/optim.py MultiSteps``).

Data parallel (JAX's 'data' mesh axis): in a ``torch.distributed``
process group (``parallel/distributed.py``, one process per card under
``torchrun``) the ``Trainer`` wraps the model with
``DistributedDataParallel``, which broadcasts rank 0's parameters, and
each rank trains on its rows of every global batch (``data/dataset.py
HostRowShard``). Every train step runs its forward through that wrapper
(``parallel/distributed.py run_forward``: the step functions' bodies,
bf16 copies, remat and the scheduled-sampling rollout included), so its
backward averages the gradients over the ranks. The loss is a full-tensor
mean, and the ranks hold equal shards of one collated batch (the same
rows and time length), so the average of their gradients is the global
batch's: the mean of equal-sized means is the mean. Accumulation
(``MultiSteps``) averages those averages, the same mean again. Dropout
masks are drawn per rank's rows from the step's seed, so with dropout a
rank's masks are not the single-process run's. Logged losses and metrics
are reduced over the ranks; rank 0 alone writes ``metrics.jsonl`` and the
checkpoints, and every rank waits for its last save before ``fit``
returns.

Parameter sharding (JAX's 'model' mesh axis above 1, ``trainer.mesh_shape:
[data, model]``): the ``Trainer`` keeps on each rank its slice of every
parameter JAX's ``param_sharding`` splits, and the optimizer's state of
that layout (``parallel/distributed.py shard_parameters``). Each train
step runs inside ``gathered(model, grads=True)``: the slices are gathered
whole over the model axis, the unchanged step body runs on whole weights
(the kernels take whole gate matrices, as JAX keeps them whole), and the
gradients are averaged over the data axis, each rank keeping the slice it
owns, which the optimizer updates. The eval steps and the generation eval
gather too. Rows are split over 'data' only, so the ranks of one model
group see the same rows; DDP is not used there.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.infer.generate import (
    _generate_lws,
    _generate_metaformer,
)
from multimodalreactiongeneration_tpu_torch.models.simple_lstm import (
    mse_loss,
    simple_lstm_loss,
    split_and_form,
    static_base,
)
from multimodalreactiongeneration_tpu_torch.nn.basic import dropout_rng
from multimodalreactiongeneration_tpu_torch.ops.masks import PADDING_VALUE
from multimodalreactiongeneration_tpu_torch.parallel import distributed
from multimodalreactiongeneration_tpu_torch.parallel.distributed import (
    gathered,
    run_forward,
)
from multimodalreactiongeneration_tpu_torch.parallel.mesh import (
    DataMesh,
    make_mesh,
    param_sharding,
)
from multimodalreactiongeneration_tpu_torch.train import checkpoint as ckpt_lib
from multimodalreactiongeneration_tpu_torch.train.losses import build_loss
from multimodalreactiongeneration_tpu_torch.train.metrics import (
    MetricAccumulator,
    gen_target_dict,
    per_slice_sq_err,
)
from multimodalreactiongeneration_tpu_torch.train.optim import (
    cosine_annealing,
    map_param_state,
    set_learning_rate,
)

# the 7-tuple of (data, lengths) pairs: fbank_p, motion_p, motion_s,
# lead_fbank, lead_mp, lead_ms, target
Batch = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def delta_scaler(feat_dim: int, delta_order: int, scale: float,
                 device=None) -> torch.Tensor:
    """1 on the static channels, sqrt(scale) on the delta channels."""
    s = torch.ones(feat_dim, device=device)
    s[feat_dim // (delta_order + 1):] = scale ** 0.5
    return s


def _step_seed(generator: Optional[torch.Generator]) -> Optional[int]:
    """One step's dropout seed from ``generator``; None without one."""
    if generator is None:
        return None
    return int(torch.randint(0, 2**62, (1,), generator=generator))


@contextlib.contextmanager
def bf16_sums_in_f32():
    """cuBLAS's bf16 products with every partial sum in f32 inside the
    block, the setting restored after: PyTorch lets them add split-K
    partial sums in bf16 by default, where JAX's bf16 products sum in
    f32 and round once."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


def _cast_floats(tensors, dtype):
    return tuple(t.to(dtype) if t.is_floating_point() else t
                 for t in tensors)


def streaming_step_fns(
    model: torch.nn.Module,
    model_cfg: Dict[str, Any],
    metrics_cfg: Dict[str, Any],
    optimizer: torch.optim.Optimizer,
    mask_self_motion_input: bool,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
):
    """(train_step, eval_step) for a streaming model. The Metaformer
    zeroes the -100 padding of its self-motion input
    (``mask_self_motion_input=True``); LSTMwithSample takes it as it is.

    ``train_step(batch, generator=None) -> (loss, per_slice)`` runs
    forward, loss, backward and one optimizer step on ``model``'s
    parameters, its dropout masks from a seed drawn from ``generator``;
    ``eval_step(batch) -> (loss, per_slice)`` runs the forward without a
    gradient. ``per_slice`` maps each feature slice to (sum_sq_err,
    count), on the device. ``remat``: the model call under
    ``torch.utils.checkpoint``. ``compute_dtype``: f32, or bf16 for the
    mixed-precision train step (the module docstring)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: f32 or bf16")
    bf16 = compute_dtype == torch.bfloat16
    lossfun = build_loss(model_cfg)
    target_dict = gen_target_dict(
        metrics_cfg["use_centroid"],
        metrics_cfg["use_angle"],
        metrics_cfg["delta_order"],
    )
    delta_order = metrics_cfg["delta_order"]
    dls = model_cfg.get("delta_loss_scale", 1.0)

    def apply(seed: Optional[int], params, *arrays):
        with dropout_rng(seed):
            if params is None:
                return model(*arrays)[0]
            return torch.func.functional_call(model, params, arrays)[0]

    def forward(batch: Batch, seed: Optional[int] = None,
                lowp: bool = False):
        a_p, m_p, m_s, la, lmp, lms, target = [b[0] for b in batch]
        if mask_self_motion_input:
            m_s = m_s * (m_s != PADDING_VALUE)
        arrays = (a_p, m_p, m_s, la, lmp, lms)
        params = None
        if lowp:  # JAX's _cast_tree of the parameters and the six inputs
            params = {name: p.to(compute_dtype) if p.is_floating_point()
                      else p for name, p in model.named_parameters()}
            arrays = _cast_floats(arrays, compute_dtype)
        if remat and model.training:
            y = checkpoint(apply, seed, params, *arrays, use_reentrant=False)
        else:
            y = apply(seed, params, *arrays)
        y = y[:, lmp.shape[1]:].float()
        mask = (target != PADDING_VALUE).to(y.dtype)
        return y * mask, target * mask

    def train_step(batch: Batch,
                   generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        seed = _step_seed(generator)
        with gathered(model, grads=True), (
                bf16_sums_in_f32() if bf16 else contextlib.nullcontext()):
            y, t = run_forward(
                model, lambda _, b: forward(b, seed, lowp=bf16), batch)
            scaler = delta_scaler(y.shape[-1], delta_order, dls, y.device)
            y, t = y * scaler, t * scaler
            loss = lossfun(y, t)
            loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(y.detach(), t, target_dict)

    @torch.no_grad()
    def eval_step(batch: Batch):
        model.eval()
        with gathered(model):
            y, t = forward(batch)
        return lossfun(y, t), per_slice_sq_err(y, t, target_dict)

    return train_step, eval_step


def scheduled_sampling_masked_step_fn(
    model: torch.nn.Module,
    model_type: str,
    model_cfg: Dict[str, Any],
    metrics_cfg: Dict[str, Any],
    optimizer: torch.optim.Optimizer,
):
    """``masked_step(batch, mask_steps) -> (loss, per_slice)``: the
    scheduled-sampling step on a given (L,) bool mask (True: the step
    feeds back the model's prediction), the body of
    ``scheduled_sampling_step_fn``'s step. The loss is the
    ``delta_scaler``-scaled, -100-masked loss of the rollout's prediction;
    forward, backward and one optimizer step, as JAX's ``train_step``
    (no f32 gradient cast there either)."""
    lossfun = build_loss(model_cfg)
    target_dict = gen_target_dict(
        metrics_cfg["use_centroid"],
        metrics_cfg["use_angle"],
        metrics_cfg["delta_order"],
    )
    delta_order = metrics_cfg["delta_order"]
    dls = model_cfg.get("delta_loss_scale", 1.0)
    if model_type == "lstm_with_sampling":
        rollout = _generate_lws
    else:
        def rollout(model, data, mask):
            return _generate_metaformer(model, data, mask,
                                        cache_dtype=torch.float32,
                                        kv_layout="per_block")

    def masked_step(batch: Batch, mask_steps: torch.Tensor):
        data = [b[0] for b in batch]
        target = data[-1]
        optimizer.zero_grad(set_to_none=True)
        with gathered(model, grads=True):
            y = run_forward(model, rollout, data,
                            mask_steps.to(target.device))
            mask = (target != PADDING_VALUE).to(y.dtype)
            y, t = y * mask, target * mask
            scaler = delta_scaler(y.shape[-1], delta_order, dls, y.device)
            y, t = y * scaler, t * scaler
            loss = lossfun(y, t)
            loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(y.detach(), t, target_dict)

    return masked_step


def scheduled_sampling_step_fn(
    model: torch.nn.Module,
    model_type: str,
    model_cfg: Dict[str, Any],
    metrics_cfg: Dict[str, Any],
    optimizer: torch.optim.Optimizer,
):
    """``train_step(batch, generator, rate) -> (loss, per_slice)`` for
    ``use_scheduled_sampling`` (reference lstm_with_sample.py:278-301,
    lstmformer.py:357-385): the mask is ``uniform(L) < rate`` with L the
    batch's motion length, drawn from ``generator``, then
    ``scheduled_sampling_masked_step_fn``'s step."""
    masked_step = scheduled_sampling_masked_step_fn(
        model, model_type, model_cfg, metrics_cfg, optimizer)

    def train_step(batch: Batch, generator: torch.Generator, rate: float):
        length = batch[1][0].shape[1]
        mask = torch.rand(length, generator=generator) < rate
        return masked_step(batch, mask)

    return train_step


def windowed_step_fns(
    model: torch.nn.Module,
    model_cfg: Dict[str, Any],
    metrics_cfg: Dict[str, Any],
    optimizer: torch.optim.Optimizer,
):
    """(train_step, eval_step) for SimpleLSTM: each takes a batch
    (fbank (B, Ta, 81), motion (B, Tm, 18), target (B, 1, 18)) and returns
    (loss, per_slice), as ``streaming_step_fns``' do; ``train_step`` also
    takes their ``generator``."""
    target_dict = gen_target_dict(
        metrics_cfg["use_centroid"],
        metrics_cfg["use_angle"],
        metrics_cfg["delta_order"],
    )

    def row_mask(target):
        """1 for real rows, 0 for rows that are all -100 (filler): the
        windowed loss has no element mask, so those rows are zeroed out
        of prediction AND target, and stay in the mean's denominator."""
        real = ~(target == PADDING_VALUE).flatten(1).all(dim=1)
        return real.reshape((-1,) + (1,) * (target.dim() - 1))

    def train_step(batch, generator: Optional[torch.Generator] = None):
        fbank, motion, target = batch
        model.train()
        optimizer.zero_grad(set_to_none=True)
        m = row_mask(target)
        with gathered(model, grads=True):
            with dropout_rng(_step_seed(generator)):
                y = run_forward(model, lambda mod, a, b: mod(a, b), fbank,
                                motion)
            loss, y = simple_lstm_loss(y, target, motion, model_cfg,
                                       metrics_cfg, row_mask=m)
            loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(
            y.detach(), target * m.to(target.dtype), target_dict)

    @torch.no_grad()
    def eval_step(batch):
        fbank, motion, target = batch
        model.eval()
        with gathered(model):
            y = model(fbank, motion)
        if model_cfg.get("all_static", False):
            y = split_and_form(motion, y, metrics_cfg["delta_order"],
                               static_base(metrics_cfg))
        m = row_mask(target).to(y.dtype)
        y, target = y * m, target * m
        return mse_loss(y, target), per_slice_sq_err(y, target, target_dict)

    return train_step, eval_step


def _is_paired(batch) -> bool:
    """Streaming batches are [(data, lengths), ...]; windowed batches are
    stacked arrays."""
    last = batch[-1]
    return isinstance(last, (tuple, list)) and len(last) == 2


def _batch_frames(batch) -> int:
    """Real (unpadded) motion frames in a batch, for the per-epoch
    throughput record, with no device sync: the target's host lengths of a
    streaming batch; B*T of a windowed batch's target."""
    if _is_paired(batch):
        return int(np.asarray(batch[-1][1]).sum())
    shape = batch[-1].shape
    return int(shape[0] * shape[1])


def _pack(loss, slices) -> Tuple[torch.Tensor, List[str]]:
    """One device vector [loss, s_0, c_0, s_1, c_1, ...] and the slice
    names, so an epoch's scalars read back as one array. Names in sorted
    order, as the JAX package flattens the dict: the records list the
    slices in the same order."""
    names = sorted(slices)
    flat = [loss.reshape(())]
    for name in names:
        flat += [x.reshape(()).to(loss.dtype) for x in slices[name]]
    return torch.stack(flat), names


def _reduce_ranks(packed: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Rows of ``_pack`` vectors over the mesh's data axis: each step's
    loss averaged over its ranks (the global batch's, from equal shards),
    the slices' squared-error sums and counts summed. The ranks of one
    model group hold the same rows, so the data axis alone counts them."""
    total = distributed.axis_sum(packed, mesh.group("data"))
    return torch.cat([total[:, :1] / mesh.data, total[:, 1:]], dim=1)


def _unpack_rows(arr: np.ndarray, names: List[str], acc: MetricAccumulator):
    for row in arr:
        acc.update({n: (row[1 + 2 * i], row[2 + 2 * i])
                    for i, n in enumerate(names)})


@dataclass
class FitResult:
    epochs_run: int = 0
    best_val_loss: float = float("inf")
    history: List[Dict[str, float]] = field(default_factory=list)
    ckpt_dir: Optional[str] = None


class Trainer:
    """``fit`` with checkpoint and early-stop callbacks, on one device or
    data-parallel over a ``torch.distributed`` process group.

    ``train_step(batch, generator) -> (loss, per_slice)`` and
    ``eval_step(batch) -> (loss, per_slice)`` are ``streaming_step_fns``'
    or ``windowed_step_fns``'; with ``scheduled_max_epochs``, the train
    step is ``scheduled_sampling_step_fn``'s, called as
    ``train_step(batch, generator, rate)``. ``generator`` is the
    trainer's, made at the start of ``fit`` from ``seed`` (JAX's
    ``PRNGKey(seed)``): the steps draw their dropout seeds and
    scheduled-sampling masks from it. The model's parameters and the
    optimizer are updated in place. Batches are staged onto ``device``
    (``cuda:0`` unless named).

    ``mesh``: a ``parallel/mesh.py DataMesh`` over the process group
    (``make_mesh()``, every rank on the data axis, by default), checked
    against the group. Where a process group is initialized and the
    mesh's 'model' axis is 1, the model is wrapped for data parallel
    (``parallel/distributed.py data_parallel``; the module docstring);
    above 1 its parameters and the optimizer's state are sharded by JAX's
    ``param_sharding`` (``parallel/distributed.py shard_parameters``), the
    step functions gather them whole for each step, and the gradients are
    averaged over the data axis. Make the Trainer on every rank, after the
    step functions (and any restore of a checkpoint) and before the first
    step. Feed each rank its mesh's ``data_rank``-th rows.

    Each epoch's record holds the global batch's frames under data
    parallel: ``train_frames`` is summed over the data axis, so
    ``train_frames_per_s`` is the job's rate, not rank 0's (JAX's loop
    counts a process's own rows)."""

    def __init__(
        self,
        model: torch.nn.Module,
        train_step: Callable,
        eval_step: Callable,
        optimizer: torch.optim.Optimizer,
        optim_cfg,
        callbacks_cfg=None,
        log_dir: str = "log",
        ckpt_dir: Optional[str] = None,
        mesh=None,
        generation_eval: Optional[Callable] = None,
        scheduled_max_epochs: Optional[int] = None,
        seed: int = 0,
        val_check_interval: float = 1.0,
        device=None,
    ):
        if mesh is None:
            mesh = make_mesh()
        if not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh: a parallel.mesh.DataMesh, got {mesh!r}")
        if mesh.world_size != distributed.world_size():
            raise ValueError(
                f"a {mesh.data}x{mesh.model} mesh in a process group of "
                f"{distributed.world_size()}")
        self.mesh = mesh
        self.shards = None
        if mesh.model > 1:
            self.shards = distributed.shard_parameters(
                model, mesh, param_sharding(model, mesh))
            map_param_state(optimizer, self.shards.slice_state)
        elif torch.distributed.is_initialized():
            distributed.data_parallel(model)
        self.model = model
        self.train_step = train_step
        self.eval_step = eval_step
        self.optimizer = optimizer
        self.optim_cfg = optim_cfg
        self.callbacks = callbacks_cfg or {}
        self.log_dir = log_dir
        self.ckpt_dir = ckpt_dir
        self.generation_eval = generation_eval
        self.scheduled_max_epochs = scheduled_max_epochs
        self.seed = seed
        self.generator: Optional[torch.Generator] = None
        self.val_check_interval = float(val_check_interval)
        self.device = resolve_device(device)
        self.primary = ckpt_lib.is_primary()
        os.makedirs(log_dir, exist_ok=True)
        self._metrics_path = os.path.join(log_dir, "metrics.jsonl")

    def _stage(self, batch):
        """Host or device batch -> ``device``, contiguous. Under a process
        group the batch holds this rank's rows (``HostRowShard``). JAX's
        ``_stage`` pads a process's rows to a multiple of the devices it
        feeds, with the -100 sentinel; a process of the port feeds one
        card, so every row count divides and none is padded (a global
        batch is padded and split by ``parallel/mesh.py
        pad_batch_to_devices`` and ``shard_batch``)."""
        def put(x):
            return torch.as_tensor(x).to(self.device,
                                         non_blocking=True).contiguous()

        if _is_paired(batch):
            return [(put(x), n) for x, n in batch]
        return tuple(put(x) for x in batch)

    def _log(self, record: Dict[str, Any]) -> None:
        # one writer: every rank holds the same reduced values, and
        # concurrent appends would interleave
        if not self.primary:
            return
        with open(self._metrics_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    def fit(self, train_loader, val_loader, max_epochs: int,
            start_epoch: int = 0) -> FitResult:
        """Epochs ``start_epoch`` .. ``max_epochs - 1``; the optimizer's
        state is whatever it holds (restored by the caller on resume)."""
        cfg = self.optim_cfg
        lr_sched = (cosine_annealing(cfg["lr"], cfg["max_epochs"])
                    if cfg.get("use_lr_sched", False) else None)
        patience_epochs = self.callbacks.get("patience_epoch", max_epochs)
        use_early = self.callbacks.get("use_early_stopping", False)
        top_k = self.callbacks.get("save_top_k", 1)
        vci = self.val_check_interval
        try:
            n_train_batches = len(train_loader)
        except TypeError:
            n_train_batches = None
        if vci > 1.0:
            val_every = int(vci)
        elif n_train_batches:
            val_every = max(1, int(n_train_batches * vci))
        else:
            val_every = None
        patience = patience_epochs / vci if vci <= 1.0 else patience_epochs
        # rank 0 owns the checkpoint files (its values are every rank's);
        # sharded parameters are gathered for a snapshot on every rank
        want_ckpt = bool(self.callbacks.get("use_checkpoint", True)
                         and self.ckpt_dir)
        use_ckpt = want_ckpt and self.primary
        sharded_ckpt = want_ckpt and self.shards is not None

        result = FitResult(ckpt_dir=self.ckpt_dir)
        use_async = self.callbacks.get("async_checkpoint", False)
        savers: Dict[str, ckpt_lib.TopKCheckpointer] = {}
        if use_ckpt:
            monitors = ["V"] + (["T", "G"] if self.generation_eval else [])
            for mon in monitors:
                savers[mon] = ckpt_lib.TopKCheckpointer(
                    self.ckpt_dir, top_k=top_k, monitor=mon,
                    use_async=use_async)
        saver = savers.get("V")
        state = dict(wait_checks=0, step=0, check_idx=0, stop=False,
                     val_seconds=0.0)
        self.generator = torch.Generator().manual_seed(self.seed)

        def run_check(epoch, packed_train, rate):
            """One validation check: the val pass (+ the generation eval),
            the V/T/G monitors, early-stop bookkeeping and a check record
            in metrics.jsonl."""
            state["check_idx"] += 1
            # read first: it drains the queued train steps, so the timer
            # below charges only validation work to val_seconds
            train_so_far = (float(_reduce_ranks(torch.stack(packed_train),
                                                self.mesh)[:, 0].mean())
                            if packed_train else float("nan"))
            t_val = time.time()
            val_metrics = MetricAccumulator("valid_")
            packed_val, names = [], []
            for vbatch in val_loader:
                loss, slices = self.eval_step(self._stage(vbatch))
                vec, names = _pack(loss, slices)
                packed_val.append(vec)
            if packed_val:
                arr = _reduce_ranks(torch.stack(packed_val),
                                    self.mesh).cpu().numpy()
                val_loss = float(arr[:, 0].mean())
                _unpack_rows(arr, names, val_metrics)
            else:
                val_loss = float("nan")
            genrt_loss = None
            if self.generation_eval is not None:
                with gathered(self.model):
                    genrt = self.generation_eval(val_loader)
                genrt_loss = float(distributed.axis_sum(torch.tensor(
                    genrt, device=self.device), self.mesh.group("data"))
                    / self.mesh.data)

            snap = None
            if savers or sharded_ckpt:
                # optimizer state only in ``last`` unless "all"
                opt = (self.optimizer
                       if self.callbacks.get("save_opt_state", "last") == "all"
                       else None)
                snap = ckpt_lib.HostSnapshot(self.model, opt)
            if saver is not None and not np.isnan(val_loss):
                saver.maybe_save(snap, epoch, val_loss)
            if "T" in savers and np.isfinite(train_so_far):
                savers["T"].maybe_save(snap, epoch, train_so_far)
            if ("G" in savers and genrt_loss is not None
                    and np.isfinite(genrt_loss)):
                savers["G"].maybe_save(snap, epoch, genrt_loss)

            if val_loss < result.best_val_loss:
                result.best_val_loss = val_loss
                state["wait_checks"] = 0
            elif not np.isnan(val_loss):
                state["wait_checks"] += 1
                if use_early and state["wait_checks"] >= patience:
                    state["stop"] = True

            check = {
                "epoch": epoch,
                "step": state["step"],
                "val_check": state["check_idx"],
                "val_loss": val_loss,
                "train_loss_so_far": train_so_far,
                **val_metrics.compute(),
            }
            if genrt_loss is not None:
                check["genrt_loss"] = genrt_loss
            if rate is not None:
                check["scheduled_sampling_rate"] = rate
            self._log(check)
            state["val_seconds"] += time.time() - t_val
            return check

        for epoch in range(start_epoch, max_epochs):
            if lr_sched is not None:
                set_learning_rate(self.optimizer, float(lr_sched(epoch)))
            train_metrics = MetricAccumulator("train_")
            t0 = time.time()
            rate = (epoch / self.scheduled_max_epochs
                    if self.scheduled_max_epochs else None)
            packed_train, names = [], []
            train_frames = 0
            last_check = None
            checks_this_epoch = 0
            state["val_seconds"] = 0.0
            for batch_idx, batch in enumerate(train_loader):
                train_frames += _batch_frames(batch)
                step_args = (self.generator,) + (
                    () if rate is None else (rate,))
                loss, slices = self.train_step(self._stage(batch), *step_args)
                vec, names = _pack(loss, slices)
                packed_train.append(vec)
                state["step"] += 1
                if val_every and (batch_idx + 1) % val_every == 0:
                    last_check = run_check(epoch, packed_train, rate)
                    checks_this_epoch += 1
                    if state["stop"]:
                        break
            # the one readback of the epoch is its device sync
            if packed_train:
                arr = _reduce_ranks(torch.stack(packed_train),
                                    self.mesh).cpu().numpy()
                train_loss = float(arr[:, 0].mean())
                _unpack_rows(arr, names, train_metrics)
            else:
                train_loss = float("nan")
            train_seconds = time.time() - t0 - state["val_seconds"]
            train_frames = int(distributed.axis_sum(
                torch.tensor(train_frames, device=self.device),
                self.mesh.group("data")))
            # epoch-end validation only when no interval check ran
            if last_check is None and not state["stop"]:
                last_check = run_check(epoch, packed_train, rate)
                checks_this_epoch += 1
            val_loss = last_check["val_loss"] if last_check else float("nan")

            record = {
                "epoch": epoch,
                "step": state["step"],
                "train_loss": train_loss,
                "val_loss": val_loss,
                "lr": float(lr_sched(epoch)) if lr_sched else cfg["lr"],
                "epoch_seconds": time.time() - t0,
                "train_seconds": round(train_seconds, 4),
                "train_frames": train_frames,
                "train_frames_per_s": round(
                    train_frames / max(train_seconds, 1e-9), 1),
                "val_checks": checks_this_epoch,
                "val_seconds": round(state["val_seconds"], 4),
                **train_metrics.compute(),
            }
            if last_check:
                record.update({k: v for k, v in last_check.items()
                               if k.startswith("valid_")})
                if "genrt_loss" in last_check:
                    record["genrt_loss"] = last_check["genrt_loss"]
            if rate is not None:
                record["scheduled_sampling_rate"] = rate
            self._log(record)
            result.history.append(record)
            result.epochs_run = epoch + 1
            if state["stop"]:
                break
        if saver is not None or sharded_ckpt:
            snap = ckpt_lib.HostSnapshot(self.model, self.optimizer)
            if saver is not None:
                saver.save_last(snap, result.epochs_run - 1)
        for s in savers.values():
            s.wait()  # flush background saves before anyone reads ckpt_dir
        # no collective follows the last eval step: hold every rank until
        # rank 0's saves are on disk, so none reads ckpt_dir early
        distributed.barrier()
        return result
