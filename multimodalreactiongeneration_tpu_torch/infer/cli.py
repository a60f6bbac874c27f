"""Evaluation CLI: the port's counterpart of the JAX package's ``infer/cli.py``
(reference visualize_metaformer main, visualize_metaformer.py:367-385).

Loads a checkpoint, builds manifests over an eval corpus, runs batched
full-generation rollouts with ``speed.log`` timing, logs the genrt loss,
and renders per segment a comparison (mp4 with ffmpeg, else PNG frames
and the wav), pose strips and a nod plot:

    python -m multimodalreactiongeneration_tpu_torch.infer.cli \\
        --config configs/lstmformer.yaml \\
        model_path=ckpts/exp/last data_dir=/corpus output_path=./viz

Keys as in the JAX CLI: ``model_path`` (a checkpoint of the port's
trainer, or of ``models/torch_import.py``), ``data_dir``,
``output_path``, ``eval_batch_size`` (8), ``face_head_path``,
``render_png_only``, ``max_render_frames`` and ``source_video_dir``. The
last line printed is the JSON summary. It runs on ``cuda:0``;
``device=cpu`` runs it on the CPU. ``evaluate`` is the device part
(model, loader, generation, losses), ``render`` the host part; ``main``
runs both. Not carried over: the JAX package's compile cache (the port
compiles nothing per shape).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.configs import load_config
from multimodalreactiongeneration_tpu_torch.data.databuild_nx import (
    DataBuilderNX,
)
from multimodalreactiongeneration_tpu_torch.data.dataset import (
    BatchLoader,
    SegmentDatasetNX,
)
from multimodalreactiongeneration_tpu_torch.infer.visualize import (
    generation_speed_log,
    generator_for,
    nod_pitch_plot,
    render_comparison,
    render_segment_video,
    save_pose_strips,
)
from multimodalreactiongeneration_tpu_torch.models import build_model
from multimodalreactiongeneration_tpu_torch.train.checkpoint import (
    load_checkpoint,
)
from multimodalreactiongeneration_tpu_torch.train.generation_eval import (
    generation_loss,
)
from multimodalreactiongeneration_tpu_torch.train.losses import build_loss
from multimodalreactiongeneration_tpu_torch.utils.logging import (
    DummyLogger,
    set_logger,
)


def model_type_of(cfg) -> str:
    return cfg.get("model_type", cfg.exp.use_model)


def device_of(cfg) -> torch.device:
    """``cuda:0`` unless the config names a device (the yaml's own
    ``device: tpu`` names none of the port's)."""
    named = cfg.get("device")
    return resolve_device(None if named in (None, "tpu") else named)


def eval_dataset(cfg, logger=None) -> SegmentDatasetNX:
    """The segments of the eval corpus at ``cfg.data.data_dir`` (the
    manifests are built under ./data of the cwd, as in training)."""
    builder = DataBuilderNX(cfg.data, logger or DummyLogger())
    dataset = SegmentDatasetNX(builder.data_site, cfg.motion, cfg.audio)
    if len(dataset) == 0:
        raise ValueError("no segments found in the eval corpus")
    return dataset


def evaluate(cfg, logger=None, dataset=None):
    """The model of ``cfg.model_path`` over every segment of the eval
    corpus, in order, ``eval_batch_size`` at a time: the generations
    (``speed.log`` in ``output_path``) and their genrt losses. Returns
    (preds: host (B, L, D) arrays, batches: 7-tuples on the device,
    losses: floats), one each per batch."""
    logger = logger or DummyLogger()
    model_type = model_type_of(cfg)
    generator_for(model_type)  # simple_lstm raises before any work
    device = device_of(cfg)
    output_dir = cfg.get("output_path") or "visualize_out"
    os.makedirs(output_dir, exist_ok=True)

    model = build_model(model_type, cfg.model, device=device)
    model.load_state_dict(load_checkpoint(cfg.model_path)["params"])

    dataset = dataset if dataset is not None else eval_dataset(cfg, logger)
    loader = BatchLoader(
        dataset,
        np.arange(len(dataset)),
        batch_size=int(cfg.get("eval_batch_size", 8)),
        pad_to_multiple=cfg.trainer.get("pad_to_multiple", 16),
        shuffle=False,
        device=device,
    )
    batches = [tuple(torch.as_tensor(b[0]).to(device) for b in batch)
               for batch in loader]
    preds = generation_speed_log(
        model, model_type, batches,
        speed_log_path=os.path.join(output_dir, "speed.log"),
    )
    lossfun = build_loss(cfg.model.to_dict())
    losses = [
        float(generation_loss(torch.from_numpy(p).to(device), b[-1], lossfun))
        for p, b in zip(preds, batches)
    ]
    logger.info(f"genrt_loss over {len(losses)} batches: {np.mean(losses):.6f}")
    return preds, batches, losses


def _segment_stats(manifest):
    with np.load(manifest["self_motion"]["path"]) as z:
        return {k: z[k] for k in ("angle_mean", "angle_std", "centroid_mean",
                                  "centroid_std")}


def _partner_source(manifest, src_dir):
    """The partner's movie as a VideoSource (gen_head_motion's host/comp
    swap rule, visualize_metaformer.py:196-204), or None."""
    from multimodalreactiongeneration_tpu_torch.corpus.video import (
        HalfVideoSource,
        open_video,
    )

    target_path = manifest["self_motion"]["path"]
    who = os.path.basename(target_path)
    data_name = os.path.basename(os.path.dirname(target_path))
    partner = "comp" if "host" in who else "host"
    movie = os.path.join(src_dir, data_name, f"{partner}.mp4")
    session_movie = os.path.join(src_dir, data_name, "movie.mp4")
    if os.path.exists(movie):
        return open_video(movie)
    if os.path.exists(session_movie):
        # self-built corpora keep only the side-by-side movie.mp4: serve
        # the partner's half as a view
        return HalfVideoSource(open_video(session_movie),
                               0 if partner == "comp" else 1)
    return None


def render(cfg, preds, batches, dataset, logger=None):
    """Every eval segment end to end (reference gen_head_motion loops all
    batches): a muxed .mp4 per segment when ffmpeg is present, else PNG
    frames; pose strips and a nod plot. Returns the nod amplitude ratio
    of each segment."""
    from multimodalreactiongeneration_tpu_torch.infer.video import have_ffmpeg

    logger = logger or DummyLogger()
    output_dir = cfg.get("output_path") or "visualize_out"
    batch_size = int(cfg.get("eval_batch_size", 8))
    # a fixed face cloud re-posed per frame, like the reference's
    # sample.head (visualize_metaformer.py:57-61); pose-only dots if unset
    face = None
    if cfg.get("face_head_path"):
        from multimodalreactiongeneration_tpu_torch.data.head_io import (
            load_head_frame,
        )

        face = load_head_frame(cfg.face_head_path).face

    use_video = have_ffmpeg() and not cfg.get("render_png_only", False)
    max_frames = cfg.get("max_render_frames")
    data_fps = float(cfg.data.get("fps", 25.0))
    pred_fps = float(cfg.model.get("pred_fps", 12.5))
    src_dir = cfg.get("source_video_dir")
    n_frames, ratios = 0, []
    for bi, (pred_b, batch) in enumerate(zip(preds, batches)):
        true_b = batch[-1].cpu().numpy()
        for ii in range(pred_b.shape[0]):
            item = bi * batch_size + ii
            if item >= len(dataset):
                break
            with open(dataset.data_list[item], "r", encoding="utf-8") as f:
                manifest = json.loads(f.readline())
            stats = _segment_stats(manifest)
            seg = os.path.splitext(
                os.path.basename(dataset.data_list[item]))[0]
            true = true_b[ii]
            valid = true[:, 0] != -100.0
            pred, true = pred_b[ii][valid], true[valid]
            wav = manifest["partner_audio"]["path"]
            source = (_partner_source(manifest, src_dir)
                      if use_video and src_dir else None)
            if use_video:
                n_frames += render_segment_video(
                    pred, true, stats,
                    os.path.join(output_dir, seg, f"{seg}.mp4"),
                    wav_path=wav, seq=manifest["self_motion"]["seq"],
                    data_fps=data_fps, pred_fps=pred_fps, face=face,
                    max_frames=max_frames, source=source,
                )
            else:
                n_frames += render_comparison(
                    pred, true, stats, os.path.join(output_dir, seg),
                    wav_path=wav, max_frames=max_frames, face=face,
                )
            save_pose_strips(pred, true, stats, os.path.join(output_dir, seg),
                             face=face)
            ratios.append(nod_pitch_plot(
                pred, true, stats, os.path.join(output_dir, seg, "nod.png")))
    ratio = float(np.mean(ratios)) if ratios else 0.0
    logger.info(
        f"rendered {n_frames} frames over {len(ratios)} segments "
        f"({'mp4' if use_video else 'png'}); "
        f"mean nod amplitude ratio: {ratio:.3f}"
    )
    return ratios


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    logger = set_logger("visualize", cfg.get("log_dir", "log"))
    generator_for(model_type_of(cfg))
    dataset = eval_dataset(cfg, logger)
    preds, batches, losses = evaluate(cfg, logger, dataset)
    ratios = render(cfg, preds, batches, dataset, logger)
    summary = {
        "genrt_loss": float(np.mean(losses)),
        "nod_ratio": float(np.mean(ratios)) if ratios else 0.0,
        "batches": len(batches),
        "output": cfg.get("output_path") or "visualize_out",
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
