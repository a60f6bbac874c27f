"""Training CLI: the port's counterpart of the JAX package's ``train/cli.py``.

Usage (the run/*/train.sh contract):

    python -m multimodalreactiongeneration_tpu_torch.train.cli \\
        --config configs/lstmformer.yaml \\
        name=exp-01 data_dir=/path/corpus ckpt_path=./ckpts log_dir=./log

``--config`` is a yaml file, read as the JAX loader reads it
(``configs.py load_config``: any of the five shipped configs, or an
edited copy under any name); ``key=value`` dotted overrides apply as in
the JAX loader. The run builds the corpus manifests and loaders of its
model: for the streaming models (``exp.use_model`` lstmformer, with LSTM
or GRU embeddings, and lstm_with_sampling) ``data/databuild_nx.py`` and
the bucketed loaders with the corpus audio resident on the device
(``make_streaming_loaders``); for simple_lstm ``data/databuild.py``
window manifests over per-frame ``.head`` pickles and fixed-shape
window batches (``make_windowed_loaders``). Then the model
(``models.build_model``), its step functions (``train/harness.py``:
``streaming_step_fns``, where the lstmformer's self-motion input has its
-100 padding zeroed and lstm_with_sampling's is fed as it is, as in the
JAX package; ``windowed_step_fns`` for simple_lstm), the generation eval
(not for simple_lstm, as in the JAX CLI), and ``Trainer.fit``;
``resume_from=<checkpoint>`` (e.g. ``<ckpt>/last``) restores the weights,
the optimizer state (with a partial gradient accumulation) and the epoch.
As in the JAX CLI, ``model.use_scheduled_sampling=true`` trains the
streaming models on the AR rollout (``scheduled_sampling_step_fn``, rate
epoch / ``model.max_epochs``), ``trainer.accumulate_grad_batches`` k
averages k batches' gradients into each optimizer update
(``optim.MultiSteps``), ``trainer.remat=true`` recomputes the forward in
the backward, and ``model.dropout`` (``dropout_rate``,
``sampler_dropout_rate``) acts in training; ``trainer.precision: bf16``
trains the streaming models on the bf16 step (``streaming_step_fns``
with ``compute_dtype=torch.bfloat16``: the lstmformer with LSTM or GRU
embeddings, lstm_with_sampling; the scheduled-sampling step and
simple_lstm's windowed step stay f32), with f32 parameters, optimizer
state and checkpoints.

Data parallel on N GPUs, one process per card:

    torchrun --nproc_per_node N -m \
        multimodalreactiongeneration_tpu_torch.train.cli --config ...

Each rank joins the process group from torchrun's environment
(``parallel/distributed.py initialize_multihost``; NCCL on CUDA, gloo on
the CPU), takes the card ``LOCAL_RANK``, iterates the same global batches
and keeps its rows (``HostRowShard``, as the JAX CLI wraps its loaders
when its process count is above 1); ``Trainer`` averages the gradients
over the ranks (DDP). Rank 0 writes the log, ``metrics.jsonl`` and the
checkpoints. ``trainer.mesh_shape: [data, model]`` lays the ranks out as
JAX's (data, model) mesh, ``data x model`` the world size (``torchrun
--nproc_per_node data*model``): with ``model`` 1 the run is data parallel
as above; above 1 each rank stores its slice of the parameters JAX's
``param_sharding`` splits and of their optimizer state, every step
gathers them whole, the rows are split over 'data' only and the gradients
averaged over it (``train/harness.py Trainer``); the checkpoints hold
whole tensors, and ``resume_from`` loads them whole before each rank keeps
its slice. ``exp.batch_size`` is the global batch.

It runs on ``cuda:0`` (``cuda:LOCAL_RANK`` under torchrun); ``device=cpu``
runs it on the CPU (the tests do). The yaml's own ``device: tpu`` names
no device of the port and means the default. Not carried over: the JAX
package's persistent compile cache (the port compiles nothing per
shape).
"""

from __future__ import annotations

import argparse
import os

import torch

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.configs import load_config
from multimodalreactiongeneration_tpu_torch.data.audio_cache import (
    DeviceAudioCache,
)
from multimodalreactiongeneration_tpu_torch.data.databuild import DataBuilder
from multimodalreactiongeneration_tpu_torch.data.databuild_nx import (
    DataBuilderNX,
)
from multimodalreactiongeneration_tpu_torch.data.dataset import (
    BatchLoader,
    HostRowShard,
    PrefetchLoader,
    SegmentDatasetNX,
    WindowBatchLoader,
    WindowDataset,
    random_split_indices,
)
from multimodalreactiongeneration_tpu_torch.models import MODEL_TYPE, build_model
from multimodalreactiongeneration_tpu_torch.parallel import distributed
from multimodalreactiongeneration_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
)
from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
    load_checkpoint,
    restore_opt_state,
)
from multimodalreactiongeneration_tpu_torch.train.generation_eval import (
    make_generation_eval,
)
from multimodalreactiongeneration_tpu_torch.train.harness import (
    Trainer,
    scheduled_sampling_step_fn,
    streaming_step_fns,
    windowed_step_fns,
)
from multimodalreactiongeneration_tpu_torch.train.optim import build_optimizer
from multimodalreactiongeneration_tpu_torch.utils.logging import (
    DummyLogger,
    set_logger,
)


def _row_shard(loader, mesh):
    """``loader`` as this rank's rows of its batches (``HostRowShard`` at
    the mesh's place on its data axis) where that axis has more than one
    rank; itself otherwise."""
    if mesh.data == 1:
        return loader
    return HostRowShard(loader, mesh.data_rank, mesh.data)


def make_streaming_loaders(cfg, logger, device=None, mesh=None):
    """(train, valid, test loaders, dataset) over the corpus at
    ``cfg.data.data_dir``; the batched fbank runs on ``device``; each rank
    keeps its rows of the ``mesh``'s data axis (``make_mesh()``, every
    rank, by default)."""
    device = resolve_device(device)
    mesh = make_mesh() if mesh is None else mesh
    builder = DataBuilderNX(cfg.data, logger)
    dataset = SegmentDatasetNX(builder.data_site, cfg.motion, cfg.audio)
    if len(dataset) == 0:
        raise ValueError("dataset is empty")
    tr, va, te = random_split_indices(
        len(dataset), cfg.exp.train_rate, cfg.exp.valid_rate,
        seed=cfg.get("seed", 0))
    logger.info(
        f"train size: {len(tr)}, valid size: {len(va)}, test size: {len(te)}")
    pad = cfg.trainer.get("pad_to_multiple", 16)
    bs = cfg.exp.batch_size
    depth = int(cfg.trainer.get("prefetch_batches", 2))

    # the corpus audio resident on the device: wavs upload once, slices
    # gather there per batch; cache_audio_mb=0 turns it off
    audio_cache = None
    cache_mb = float(cfg.trainer.get("cache_audio_mb", 1024))
    if cache_mb > 0:
        audio_cache = DeviceAudioCache.build_for_dataset(
            dataset, cfg.audio, pad, ratio=8,
            budget_bytes=int(cache_mb * 1e6), device=device)
        if audio_cache is not None:
            logger.info(f"audio cache: corpus resident on {device} "
                        f"({audio_cache.nbytes / 1e6:.0f} MB)")
        else:
            logger.info(f"audio cache: off (over {cache_mb:.0f} MB budget "
                        "or empty corpus); per-batch int16 reads")

    def mk(idx, shuffle):
        loader = BatchLoader(
            dataset, idx, bs, pad_to_multiple=pad, shuffle=shuffle,
            seed=cfg.get("seed", 0), audio_cfg=cfg.audio,
            bucket_windows=int(cfg.trainer.get("bucket_windows", 8)),
            audio_cache=audio_cache, device=device,
        )
        # data parallel: identical global batches on every rank, each
        # keeping its rows (HostRowShard's docstring has the why)
        loader = _row_shard(loader, mesh)
        return PrefetchLoader(loader, depth) if depth > 0 else loader

    return mk(tr, True), mk(va, False), mk(te, False), dataset


def make_windowed_loaders(cfg, logger, mesh=None):
    """(train, valid, test loaders, dataset) of simple_lstm's fixed
    windows over the ``.head`` corpus at ``cfg.data.data_dir``, each
    rank's rows of the ``mesh``'s data axis."""
    mesh = make_mesh() if mesh is None else mesh
    builder = DataBuilder(cfg.data, logger)
    dataset = WindowDataset(builder.data_site, cfg.data, cfg.audio)
    if len(dataset) == 0:
        raise ValueError("dataset is empty")
    tr, va, te = random_split_indices(
        len(dataset), cfg.exp.train_rate, cfg.exp.valid_rate,
        seed=cfg.get("seed", 0))
    logger.info(
        f"train size: {len(tr)}, valid size: {len(va)}, test size: {len(te)}")

    def mk(idx, shuffle):
        return _row_shard(WindowBatchLoader(
            dataset, idx, cfg.exp.batch_size, shuffle=shuffle,
            seed=cfg.get("seed", 0)), mesh)

    return mk(tr, True), mk(va, False), mk(te, False), dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("overrides", nargs="*",
                        help="key=value dotted overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    model_type = cfg.exp.use_model
    if model_type not in MODEL_TYPE:
        raise ValueError(f"exp.use_model must be one of {sorted(MODEL_TYPE)}, "
                         f"got {model_type!r}")
    named = cfg.get("device")
    if named == "tpu":
        named = None
    # data parallel: join torchrun's process group (no-op for one process)
    # over the backend of the device the run trains on
    distributed.initialize_multihost(device=named)
    mesh_shape = cfg.trainer.get("mesh_shape")
    mesh = make_mesh_2d(*map(int, mesh_shape)) if mesh_shape else make_mesh()
    device = distributed.rank_device(named)
    # rank 0 writes the log (the other ranks' values are the same)
    logger = (set_logger(model_type, cfg.get("log_dir", "log"))
              if distributed.rank() == 0 else DummyLogger())
    if distributed.world_size() > 1:
        logger.info(f"data parallel: process {distributed.rank()} of "
                    f"{distributed.world_size()}, device {device}, mesh "
                    f"{mesh.data}x{mesh.model} (data x model)")

    windowed = model_type == "simple_lstm"
    # data parallel: rank 0 builds the corpus manifests, the others read
    with distributed.rank_zero_first():
        if windowed:
            train_loader, val_loader, _, _ = make_windowed_loaders(
                cfg, logger, mesh)
        else:
            train_loader, val_loader, _, _ = make_streaming_loaders(
                cfg, logger, device, mesh)
    model_cfg = cfg.model.to_dict()
    model = build_model(
        model_type, model_cfg,
        generator=torch.Generator().manual_seed(cfg.get("seed", 0)),
        device=device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model: {model_type}, parameters: {n_params:,}, "
                f"device: {device}")
    optimizer = build_optimizer(
        model.parameters(), cfg.optim,
        accumulate_grad_batches=cfg.trainer.get("accumulate_grad_batches", 1))
    # the streaming models' option, as in the JAX CLI
    scheduled = not windowed and cfg.model.get("use_scheduled_sampling",
                                               False)
    if windowed:
        train_step, eval_step = windowed_step_fns(
            model, model_cfg, cfg.metrics.to_dict(), optimizer)
    else:
        precision = str(cfg.trainer.get("precision", 32))
        bf16 = precision in ("bf16", "bfloat16")
        if bf16 and scheduled:
            # JAX's scheduled-sampling step takes no compute dtype: the
            # option trains in f32 whatever the precision
            logger.info("trainer.precision=bf16 with scheduled sampling: "
                        "the scheduled-sampling step trains in f32")
        train_step, eval_step = streaming_step_fns(
            model, model_cfg, cfg.metrics.to_dict(), optimizer,
            mask_self_motion_input=(model_type == "lstmformer"),
            compute_dtype=(torch.bfloat16 if bf16 and not scheduled
                           else torch.float32),
            remat=cfg.trainer.get("remat", False),
        )
        if scheduled:
            train_step = scheduled_sampling_step_fn(
                model, model_type, model_cfg, cfg.metrics.to_dict(),
                optimizer)

    start_epoch = 0
    if cfg.get("resume_from"):
        payload = load_checkpoint(cfg.resume_from)
        model.load_state_dict(payload["params"])
        restored = restore_opt_state(payload, optimizer)
        start_epoch = int(payload.get("epoch", -1)) + 1
        logger.info(f"resumed from {cfg.resume_from} at epoch {start_epoch} "
                    f"(optimizer state: {'yes' if restored else 'no'})")

    generation_eval = None
    if not windowed and cfg.trainer.get("run_generation_eval", False):
        generation_eval = make_generation_eval(model, model_type, model_cfg)

    trainer = Trainer(
        model, train_step, eval_step, optimizer, cfg.optim,
        callbacks_cfg=cfg.callbacks.to_dict(),
        log_dir=cfg.get("log_dir", "log"),
        ckpt_dir=os.path.join(cfg.get("ckpt_path", "ckpts"), cfg.name),
        generation_eval=generation_eval,
        scheduled_max_epochs=cfg.model.max_epochs if scheduled else None,
        seed=cfg.get("seed", 0),
        val_check_interval=float(cfg.trainer.get("val_check_interval", 1.0)),
        device=device,
        mesh=mesh,
    )
    result = trainer.fit(train_loader, val_loader,
                         max_epochs=cfg.trainer.max_epochs,
                         start_epoch=start_epoch)
    logger.info(
        f"done: epochs={result.epochs_run} best_val={result.best_val_loss:.6f}")
    return result


if __name__ == "__main__":
    main()
