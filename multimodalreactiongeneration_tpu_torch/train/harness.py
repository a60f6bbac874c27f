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
LSTMs run ``ops/lstm_recurrence.py`` instead. f32 only.

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

``Trainer`` is the counterpart of the JAX package's fit loop on one
device: per-epoch cosine LR, Lightning ``val_check_interval`` semantics
(a fraction of the train epoch, or every N steps when > 1) with
early-stop patience counted in validation checks, V/T/G top-k
checkpoints (T and G only with a generation eval) and ``last``, and the
same ``metrics.jsonl`` records. It stages both batch layouts: the
streaming (data, lengths) pairs and the windowed stacked arrays. Losses
and metrics stay on the device through the epoch and are read back once
at its end. With ``scheduled_max_epochs`` it passes the scheduled-sampling
step ``rate = epoch / scheduled_max_epochs`` and writes it into the check
and epoch records, as the JAX loop does. Gradient accumulation is the
optimizer's (``train/optim.py MultiSteps``). A device mesh and multi-host
runs raise ``NotImplementedError`` (ROADMAP queue A, item 6).
"""

from __future__ import annotations

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
from multimodalreactiongeneration_tpu_torch.train import checkpoint as ckpt_lib
from multimodalreactiongeneration_tpu_torch.train.losses import build_loss
from multimodalreactiongeneration_tpu_torch.train.metrics import (
    MetricAccumulator,
    gen_target_dict,
    per_slice_sq_err,
)
from multimodalreactiongeneration_tpu_torch.train.optim import (
    cosine_annealing,
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
    ``torch.utils.checkpoint``."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            "the port trains in f32 only (bf16 training is ROADMAP queue B)")
    lossfun = build_loss(model_cfg)
    target_dict = gen_target_dict(
        metrics_cfg["use_centroid"],
        metrics_cfg["use_angle"],
        metrics_cfg["delta_order"],
    )
    delta_order = metrics_cfg["delta_order"]
    dls = model_cfg.get("delta_loss_scale", 1.0)

    def apply(seed: Optional[int], *arrays):
        with dropout_rng(seed):
            return model(*arrays)[0]

    def forward(batch: Batch, seed: Optional[int] = None):
        a_p, m_p, m_s, la, lmp, lms, target = [b[0] for b in batch]
        if mask_self_motion_input:
            m_s = m_s * (m_s != PADDING_VALUE)
        arrays = (a_p, m_p, m_s, la, lmp, lms)
        if remat and model.training:
            y = checkpoint(apply, seed, *arrays, use_reentrant=False)
        else:
            y = apply(seed, *arrays)
        y = y[:, lmp.shape[1]:].float()
        mask = (target != PADDING_VALUE).to(y.dtype)
        return y * mask, target * mask

    def train_step(batch: Batch,
                   generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        y, t = forward(batch, _step_seed(generator))
        scaler = delta_scaler(y.shape[-1], delta_order, dls, y.device)
        y, t = y * scaler, t * scaler
        loss = lossfun(y, t)
        loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(y.detach(), t, target_dict)

    @torch.no_grad()
    def eval_step(batch: Batch):
        model.eval()
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
        y = rollout(model, data, mask_steps.to(target.device))
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
        with dropout_rng(_step_seed(generator)):
            y = model(fbank, motion)
        loss, y = simple_lstm_loss(y, target, motion, model_cfg, metrics_cfg,
                                   row_mask=m)
        loss.backward()
        optimizer.step()
        return loss.detach(), per_slice_sq_err(
            y.detach(), target * m.to(target.dtype), target_dict)

    @torch.no_grad()
    def eval_step(batch):
        fbank, motion, target = batch
        model.eval()
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
    """``fit`` on one device with checkpoint and early-stop callbacks.

    ``train_step(batch, generator) -> (loss, per_slice)`` and
    ``eval_step(batch) -> (loss, per_slice)`` are ``streaming_step_fns``'
    or ``windowed_step_fns``'; with ``scheduled_max_epochs``, the train
    step is ``scheduled_sampling_step_fn``'s, called as
    ``train_step(batch, generator, rate)``. ``generator`` is the
    trainer's, made at the start of ``fit`` from ``seed`` (JAX's
    ``PRNGKey(seed)``): the steps draw their dropout seeds and
    scheduled-sampling masks from it. The model's parameters and the
    optimizer are updated in place. Batches are staged onto ``device``
    (``cuda:0`` unless named)."""

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
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: a mesh and multi-host "
                "training come with data-parallel training (ROADMAP queue "
                "A, item 6)")
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
        os.makedirs(log_dir, exist_ok=True)
        self._metrics_path = os.path.join(log_dir, "metrics.jsonl")

    def _stage(self, batch):
        def put(x):
            return torch.as_tensor(x).to(self.device, non_blocking=True)

        if _is_paired(batch):
            return [(put(x), n) for x, n in batch]
        return tuple(put(x) for x in batch)

    def _log(self, record: Dict[str, Any]) -> None:
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
        use_ckpt = self.callbacks.get("use_checkpoint", True) and self.ckpt_dir

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
            train_so_far = (float(torch.stack([p[0] for p in packed_train])
                                  .mean()) if packed_train else float("nan"))
            t_val = time.time()
            val_metrics = MetricAccumulator("valid_")
            packed_val, names = [], []
            for vbatch in val_loader:
                loss, slices = self.eval_step(self._stage(vbatch))
                vec, names = _pack(loss, slices)
                packed_val.append(vec)
            if packed_val:
                arr = torch.stack(packed_val).cpu().numpy()
                val_loss = float(arr[:, 0].mean())
                _unpack_rows(arr, names, val_metrics)
            else:
                val_loss = float("nan")
            genrt_loss = None
            if self.generation_eval is not None:
                genrt_loss = float(self.generation_eval(val_loader))

            snap = None
            if savers:
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
                arr = torch.stack(packed_train).cpu().numpy()
                train_loss = float(arr[:, 0].mean())
                _unpack_rows(arr, names, train_metrics)
            else:
                train_loss = float("nan")
            train_seconds = time.time() - t0 - state["val_seconds"]
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
        if saver is not None:
            saver.save_last(ckpt_lib.HostSnapshot(self.model, self.optimizer),
                            result.epochs_run - 1)
        for s in savers.values():
            s.wait()  # flush background saves before anyone reads ckpt_dir
        return result
