"""Generation evaluation and rendering.

Counterpart of ``multimodalreactiongeneration_tpu/infer/visualize.py``
(reference visualize_metaformer.py):
  * ``generation_speed_log``: batched full generations, each batch's wall
    clock appended to ``speed.log`` (:115-127), the reference's only
    latency metric; on the card the flagship's generation runs the
    encoder-stack kernel (K1) and the rollout kernel (K2), lws's the
    stacked-LSTM kernel (K9);
  * de-standardization through the npz stats (:129-132);
  * predicted-vs-ground-truth rendering (:239-267): the face landmark
    cloud re-posed per frame and the heading vector (head_pose_plotter,
    visualizer.py:84-123), drawn with PIL; per segment a muxed .mp4
    through the ffmpeg pipe writer (``infer/video.py``,
    ``render_segment_video``) or a PNG sequence beside the wav;
  * 5-second pitch ("nod") plots and the amplitude ratio (:300-318),
    with matplotlib.

The rendering is host numpy, as in the JAX module, with PIL and
matplotlib imported inside the functions that draw.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch.infer.generate import (
    generate_lws,
    generate_metaformer,
    sampling_mask_for,
)
from multimodalreactiongeneration_tpu_torch.ops.rotations import (
    angles_to_matrix,
)


def destandardize(
    motion: np.ndarray, stats: Dict[str, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, >=6) standardized [angle, centroid] -> raw degrees / coords."""
    angle = motion[..., :3] * stats["angle_std"] + stats["angle_mean"]
    centroid = motion[..., 3:6] * stats["centroid_std"] + stats["centroid_mean"]
    return angle, centroid


def generator_for(model_type: str):
    """The generation of ``model_type``: ``generate_lws`` or
    ``generate_metaformer`` (bf16 caches, its default); simple_lstm has
    none here."""
    if model_type == "lstm_with_sampling":
        return generate_lws
    if model_type == "lstmformer":
        return generate_metaformer
    raise ValueError(
        f"model type {model_type!r} has no streaming generation "
        "engine; simple_lstm uses infer/simple_generate.py"
    )


def generation_speed_log(
    model,
    model_type: str,
    batches: List[Sequence[torch.Tensor]],
    speed_log_path: str = "speed.log",
) -> List[np.ndarray]:
    """Full-generation rollouts, per-batch wall clock appended to speed.log
    (reference :115-127, reset semantics :369-371). ``batches`` hold the
    7-tuples on the model's device; the predictions come back as host
    arrays (B, L, D). The clock stops after the device has finished."""
    if os.path.exists(speed_log_path):
        os.remove(speed_log_path)
    gen = generator_for(model_type)
    preds = []
    for data in batches:
        t0 = time.perf_counter()
        mask = sampling_mask_for(data[1].shape[1], "full",
                                 device=data[1].device)
        pred = gen(model, data, mask)
        if pred.is_cuda:
            torch.cuda.synchronize(pred.device)
        dt = time.perf_counter() - t0
        frames = int(pred.shape[0] * pred.shape[1])
        with open(speed_log_path, "a", encoding="utf-8") as f:
            f.write(f"{dt:.6f} sec / {frames} frames "
                    f"({frames / dt:.1f} frames/s)\n")
        preds.append(pred.cpu().numpy())
    return preds


def head_pose_plotter(
    frame: np.ndarray,
    head_pose: Optional[Dict[str, np.ndarray]],
    clr: Tuple[int, int, int] = (50, 255, 50),
    clr_sub: Tuple[int, int, int] = (50, 50, 255),
    repose_face: bool = True,
) -> np.ndarray:
    """Draw a posed face landmark cloud + heading vector onto ``frame``.

    Reference visualizer.py:84-123 semantics: the stored face cloud
    (de-rotated, centered, normalized coords) is re-posed by the frame's
    angle/centroid — ``R.T @ face + centroid`` — and every landmark is
    plotted as a 1-px dot; the heading is ``R @ [0,0,1]*200`` pixels
    drawn from the nose landmark (index 1). Landmarks outside [0, 1]
    normalized range are skipped (the mediapipe pixel-coord rule).
    ``head_pose`` is {"face": (N,3) or None, "centroid": (3,),
    "angle": (3,) degrees}; with no face cloud, falls back to a centroid
    dot so pose-only corpora still render. ``repose_face=False`` draws
    the cloud as given (already-posed raw landmarks, e.g. live FaceMesh
    output in the corpus overlay) while the heading still comes from the
    estimated angle.
    """
    from PIL import Image, ImageDraw

    if head_pose is None:
        return frame
    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img)
    h, w = frame.shape[:2]
    angle = np.asarray(head_pose["angle"], np.float32)
    centroid = np.asarray(head_pose["centroid"], np.float32)
    face = head_pose.get("face")
    R = angles_to_matrix(angle, "xyz")
    heading = (R @ (np.array([0.0, 0.0, 1.0]) * 200.0))[:2]

    if face is None:
        nose = centroid[:2]
    else:
        face = np.asarray(face, np.float32)
        if repose_face:
            face = (R.T @ face.T).T + centroid
        nose = face[1][:2]
    if 0.0 <= nose[0] <= 1.0 and 0.0 <= nose[1] <= 1.0:
        sx, sy = nose[0] * w, nose[1] * h
        draw.line(
            [sx, sy, sx + float(heading[0]), sy + float(heading[1])],
            fill=tuple(clr_sub),
            width=3,
        )
    if face is None:
        cx, cy = centroid[0] * w, centroid[1] * h
        draw.ellipse([cx - 6, cy - 6, cx + 6, cy + 6], fill=tuple(clr))
    else:
        for x, y, _ in face:
            if 0.0 <= x <= 1.0 and 0.0 <= y <= 1.0:
                px, py = float(x) * w, float(y) * h
                draw.ellipse([px - 1, py - 1, px + 1, py + 1],
                             outline=tuple(clr))
    return np.asarray(img)


def _pose_panel(
    angle_deg: np.ndarray,
    centroid: np.ndarray,
    face: Optional[np.ndarray],
    size: Tuple[int, int] = (480, 480),
    color=(60, 160, 255),
) -> np.ndarray:
    """One (H, W, 3) uint8 panel with the pose drawn on a dark board."""
    board = np.full((size[1], size[0], 3), (20, 20, 24), np.uint8)
    return head_pose_plotter(
        board,
        {"face": face, "centroid": centroid, "angle": angle_deg},
        clr=color,
        clr_sub=(255, 255, 255),
    )


def comparison_frames(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    face: Optional[np.ndarray] = None,
    max_frames: Optional[int] = None,
    size: Tuple[int, int] = (480, 480),
):
    """Yield side-by-side predicted|ground-truth frames as uint8 arrays."""
    p_ang, p_cen = destandardize(pred_motion, stats)
    t_ang, t_cen = destandardize(true_motion, stats)
    n = len(p_ang) if max_frames is None else min(max_frames, len(p_ang))
    for t in range(n):
        left = _pose_panel(p_ang[t], p_cen[t], face, size, (60, 160, 255))
        right = _pose_panel(t_ang[t], t_cen[t], face, size, (90, 220, 120))
        yield np.concatenate([left, right], axis=1)


def frames_at(source, indices: List[int]) -> List[Optional[np.ndarray]]:
    """Grab specific frame indices from a VideoSource.

    Random access (``source[i]``) when the reader supports it — the
    reference seeks per frame (visualize_metaformer.py:287) and a seek
    beats decoding an hour-long movie from frame 0 for every segment;
    otherwise one ascending pass. Indices past EOF come back as None."""

    def clean(frame):
        return np.ascontiguousarray(np.asarray(frame)[..., :3]).astype(
            np.uint8
        )

    if hasattr(source, "__getitem__"):
        n = len(source)
        return [
            clean(source[int(i)]) if 0 <= int(i) < n else None
            for i in indices
        ]
    wanted = {int(i) for i in indices}
    if not wanted:
        return []
    last = max(wanted)
    got: Dict[int, np.ndarray] = {}
    for i, frame in enumerate(source):
        if i in wanted:
            got[i] = clean(frame)
        if i >= last:
            break
    return [got.get(int(i)) for i in indices]


def composite_frames(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    source_frames: List[Optional[np.ndarray]],
    face: Optional[np.ndarray] = None,
    plot_answer: bool = True,
    max_frames: Optional[int] = None,
):
    """Reference composition (visualize_metaformer.py:239-267): the real
    movie frame on the left, a black board with the GT pose (gray) under
    the predicted pose (green) on the right. Missing source frames
    (past EOF) become black panels."""
    p_ang, p_cen = destandardize(pred_motion, stats)
    t_ang, t_cen = destandardize(true_motion, stats)
    n = len(p_ang) if max_frames is None else min(max_frames, len(p_ang))
    shape = next(
        (f.shape for f in source_frames if f is not None), (480, 480, 3)
    )
    for t in range(n):
        frame = source_frames[t] if t < len(source_frames) else None
        if frame is None:
            frame = np.zeros(shape, np.uint8)
        board = np.zeros_like(frame)
        if plot_answer:
            board = head_pose_plotter(
                board,
                {"face": face, "centroid": t_cen[t], "angle": t_ang[t]},
                clr=(50, 50, 50),
                clr_sub=(100, 50, 50),
            )
        board = head_pose_plotter(
            board,
            {"face": face, "centroid": p_cen[t], "angle": p_ang[t]},
            clr=(50, 255, 50),
        )
        yield np.concatenate([frame, board], axis=1)


def pose_strips(
    motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    face: Optional[np.ndarray] = None,
    color=(60, 160, 255),
    size: Tuple[int, int] = (480, 480),
    every: int = 3,
    per_strip: int = 8,
) -> List[np.ndarray]:
    """Static pose thumbnails -> horizontal strips (reference
    record_statics, visualize_metaformer.py:152-166 + 299-307): every
    ``every``-th frame is rendered with the centroid x pinned to 0.5
    (centered), the middle third cropped, and ``per_strip`` tiles
    concatenated per strip image."""
    ang, cen = destandardize(motion, stats)
    q = size[0] // 3
    tiles = []
    for i in range(len(ang)):
        if (i + 1) % every:
            continue
        c = np.array(cen[i], np.float32)
        c[0] = 0.5  # center
        board = _pose_panel(ang[i], c, face, size, color)
        tiles.append(board[q:-q, q:-q])
    return [
        np.concatenate(tiles[i : i + per_strip], axis=1)
        for i in range(0, len(tiles), per_strip)
    ]


def save_pose_strips(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    output_dir: str,
    face: Optional[np.ndarray] = None,
) -> int:
    """static_{k}.png (prediction) + t_static_{k}.png (ground truth)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for prefix, motion, color in (
        ("static", pred_motion, (50, 255, 50)),
        ("t_static", true_motion, (170, 170, 170)),
    ):
        for k, strip in enumerate(pose_strips(motion, stats, face, color)):
            Image.fromarray(strip).save(
                os.path.join(output_dir, f"{prefix}_{k}.png")
            )
            n += 1
    return n


def render_comparison(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    output_dir: str,
    wav_path: Optional[str] = None,
    max_frames: Optional[int] = None,
    face: Optional[np.ndarray] = None,
) -> int:
    """Side-by-side predicted/GT frame sequence -> output_dir/frame_%05d.png.

    PNG fallback for hosts without ffmpeg; render_segment_video is the
    full muxed-mp4 deliverable.
    """
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for t, frame in enumerate(
        comparison_frames(pred_motion, true_motion, stats, face, max_frames)
    ):
        Image.fromarray(frame).save(
            os.path.join(output_dir, f"frame_{t:05d}.png")
        )
        n = t + 1
    if wav_path and os.path.exists(wav_path):
        shutil.copy(wav_path, os.path.join(output_dir, "audio.wav"))
    return n


def render_segment_video(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    output_path: str,
    wav_path: Optional[str],
    seq: Optional[Dict[str, int]] = None,
    data_fps: float = 25.0,
    pred_fps: float = 12.5,
    face: Optional[np.ndarray] = None,
    max_frames: Optional[int] = None,
    encoder_cmd=None,
    runner=None,
    source=None,
) -> int:
    """Render one eval segment to an .mp4 with the dialog audio muxed in.

    The reference deliverable (visualize_metaformer.py:239-318): every
    frame of predicted-vs-GT pose video at pred_fps, then the source wav
    sliced over the segment's video-frame span [seq.start, seq.end +
    seq.stride) and muxed alongside. ``seq`` is the manifest's
    self_motion.seq dict; without it the whole wav is muxed.
    ``source`` (a VideoSource over the partner's movie) switches to the
    reference's side-by-side composition: real frame | pose board, with
    movie frames sampled at seq.start + (t+1)*seq.stride.
    Returns the number of frames written.
    """
    import subprocess

    from multimodalreactiongeneration_tpu_torch.infer.video import (
        FfmpegVideoWriter,
        cat_audio,
        patch_audio,
    )

    runner = runner or subprocess.run
    if source is not None and seq is not None:
        stride = seq.get("stride", 1)
        n = len(pred_motion) if max_frames is None else min(
            max_frames, len(pred_motion)
        )
        idx = [seq["start"] + (t + 1) * stride for t in range(n)]
        frames = composite_frames(
            pred_motion,
            true_motion,
            stats,
            frames_at(source, idx),
            face,
            max_frames=max_frames,
        )
    else:
        frames = comparison_frames(
            pred_motion, true_motion, stats, face, max_frames
        )
    writer = FfmpegVideoWriter(output_path, pred_fps, encoder_cmd=encoder_cmd)
    with writer:
        for frame in frames:
            writer.write(frame)
    if writer.frames_written and wav_path and os.path.exists(wav_path):
        patched = output_path.rsplit(".", 1)[0] + "_patched.mp4"
        if seq is not None:
            cat_audio(
                output_path,
                patched,
                wav_path,
                start=seq["start"],
                stop=seq["end"],
                fps=data_fps,
                stride=seq.get("stride", 1),
                runner=runner,
            )
        else:
            patch_audio(patched, output_path, wav_path, runner=runner)
    return writer.frames_written


def nod_pitch_plot(
    pred_motion: np.ndarray,
    true_motion: np.ndarray,
    stats: Dict[str, np.ndarray],
    output_path: str,
    pred_fps: float = 12.5,
    window_seconds: float = 5.0,
) -> float:
    """Pitch-over-time strips per 5 s window + nod-amplitude ratio
    (reference :300-318). Returns pred/GT pitch-range ratio."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    p_ang, _ = destandardize(pred_motion, stats)
    t_ang, _ = destandardize(true_motion, stats)
    pitch_p, pitch_t = p_ang[:, 0], t_ang[:, 0]
    times = np.arange(len(pitch_p)) / pred_fps

    win = int(window_seconds * pred_fps)
    n_win = max(len(pitch_p) // win, 1)
    fig, axes = plt.subplots(n_win, 1, figsize=(10, 2.2 * n_win), squeeze=False)
    for i in range(n_win):
        sl = slice(i * win, (i + 1) * win)
        ax = axes[i][0]
        ax.plot(times[sl], pitch_t[sl], label="ground truth", color="tab:green")
        ax.plot(times[sl], pitch_p[sl], label="prediction", color="tab:blue")
        ax.set_ylabel("pitch [deg]")
        if i == 0:
            ax.legend(loc="upper right")
    axes[-1][0].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(output_path)
    plt.close(fig)

    range_p = float(np.ptp(pitch_p)) if len(pitch_p) else 0.0
    range_t = float(np.ptp(pitch_t)) if len(pitch_t) else 1.0
    return range_p / max(range_t, 1e-9)
