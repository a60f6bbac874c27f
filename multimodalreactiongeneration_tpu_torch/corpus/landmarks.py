"""Head-pose estimation driver: video -> per-frame .head pickles.

A copy of ``multimodalreactiongeneration_tpu/corpus/landmarks.py`` on the
port's rotations, video sources and head IO. Reference: HeadPoseEstimation
(reference mr_gen/utils/video_analysis/landmark_estimation.py:22-177) runs
MediaPipe FaceMesh per frame, wraps each result in a FaceAdapter (centroid
+ calc_R + Euler, per frame on the CPU) and writes pickles, with
redo=False skip-if-exists resume (:126-129).

The landmark detector stays an external or injected callable (MediaPipe's
graph where it is installed, any frame -> (478, 3) callable otherwise);
everything downstream of the landmarks (centroid, rotation, Euler
decomposition) is batched: landmarks accumulate per chunk and one
``ops/rotations.py landmarks_to_pose`` call converts the whole chunk on
the device ``resolve_device`` gives (the card unless the caller names
one). Statistics are computed and stamped corpus-style at the end
(reference io.py:88-118 + patch_for_statis). For hosts without
mediapipe, ``main`` takes the detector (and the movie opener) as keyword
arguments, as ``process_corpus`` does.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.corpus.video import (
    HalfVideoSource,
    VideoSource,
)
from multimodalreactiongeneration_tpu_torch.data.head_io import (
    HeadFrame,
    write_head_frame,
)
from multimodalreactiongeneration_tpu_torch.ops.rotations import landmarks_to_pose

ZERO_PADDING = 5

# landmark detector: uint8 (H, W, C) frame -> (478, 3) normalized or None
Landmarker = Callable[[np.ndarray], Optional[np.ndarray]]


def mediapipe_landmarker(**facemesh_kwargs) -> Landmarker:
    """The production detector (external C++ via mediapipe), if installed."""
    try:
        import mediapipe as mp
    except ImportError as exc:
        raise ImportError(
            "mediapipe is not installed; pass a custom landmarker to "
            "HeadPoseEstimation (any frame -> (478, 3) callable)"
        ) from exc

    mesh = mp.solutions.face_mesh.FaceMesh(
        refine_landmarks=True, max_num_faces=1, **facemesh_kwargs
    )

    def detect(frame: np.ndarray) -> Optional[np.ndarray]:
        res = mesh.process(frame)
        if not getattr(res, "multi_face_landmarks", None):
            return None
        lms = res.multi_face_landmarks[0].landmark
        return np.array([[p.x, p.y, p.z] for p in lms], np.float32)

    return detect


class HeadPoseEstimation:
    """Estimate and persist head poses for a video stream.

    estimate_fps < video fps subsamples frames like the reference
    (stride = video_fps / estimate_fps, video_process.sh est-fps 25).
    """

    def __init__(
        self,
        landmarker: Optional[Landmarker] = None,
        estimate_fps: float = 25.0,
        chunk: int = 256,
        redo: bool = False,
        visualize: bool = False,
        encoder_cmd=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.landmarker = landmarker
        self.estimate_fps = estimate_fps
        self.chunk = chunk
        self.redo = redo
        self.visualize = visualize
        self.encoder_cmd = encoder_cmd

    def __call__(self, video: VideoSource, output_dir: str, name: str) -> int:
        """Returns the number of frames written (or found existing).

        With visualize=True an overlay movie ``<name>_visualized.mp4``
        (landmark cloud + heading per processed frame) is rendered
        alongside, like the reference's visualize mode
        (landmark_estimation.py:115-139).
        """
        if self.landmarker is None:
            self.landmarker = mediapipe_landmarker()
        os.makedirs(output_dir, exist_ok=True)
        stride = max(int(round(video.fps / self.estimate_fps)), 1)
        w, h = video.size

        writer = None
        if self.visualize:
            from multimodalreactiongeneration_tpu_torch.infer.video import (
                FfmpegVideoWriter,
            )

            writer = FfmpegVideoWriter(
                os.path.join(output_dir, f"{name}_visualized.mp4"),
                fps=self.estimate_fps,
                encoder_cmd=self.encoder_cmd,
            )

        pending_idx: List[int] = []
        pending_lms: List[np.ndarray] = []
        pending_frames: List[np.ndarray] = []
        written = 0

        def flush():
            nonlocal written
            if not pending_idx:
                return
            lms = np.stack(pending_lms)  # (n, 478, 3)
            ang, cen = landmarks_to_pose(lms, float(w), float(h),
                                         device=self.device)
            ang, cen = ang.cpu().numpy(), cen.cpu().numpy()
            for j, frame_no in enumerate(pending_idx):
                frame = HeadFrame(
                    centroid=cen[j],
                    angle=ang[j],
                    resolution=(w, h),
                    time=frame_no / video.fps,
                    frame_no=frame_no,
                    fps=video.fps,
                )
                write_head_frame(
                    _head_path(output_dir, name, frame_no), frame_no, frame
                )
                written += 1
                if writer is not None:
                    writer.write(
                        _overlay(pending_frames[j], lms[j], ang[j], cen[j])
                    )
            pending_idx.clear()
            pending_lms.clear()
            pending_frames.clear()

        # full-res frames buffer alongside landmarks in visualize mode:
        # bound the chunk so HD input stays tens of MB, not GB
        chunk = min(self.chunk, 32) if writer is not None else self.chunk

        out_index = 0
        for i, frame in enumerate(video):
            if i % stride:
                continue
            path = _head_path(output_dir, name, out_index)
            if os.path.exists(path) and not self.redo:
                out_index += 1
                if writer is not None:
                    # resumed frames still belong in the overlay movie:
                    # pass them through raw so the stream stays synced
                    flush()
                    writer.write(np.ascontiguousarray(frame[..., :3]))
                continue
            lm = self.landmarker(frame)
            if lm is None:
                write_head_frame(path, out_index, None)
                written += 1
                if writer is not None:
                    # keep overlay frames in stream order: drain the
                    # batched chunk before this raw passthrough frame
                    flush()
                    writer.write(np.ascontiguousarray(frame[..., :3]))
            else:
                pending_idx.append(out_index)
                pending_lms.append(lm)
                if writer is not None:
                    pending_frames.append(np.asarray(frame[..., :3]))
                if len(pending_idx) >= chunk:
                    flush()
            out_index += 1
        flush()
        if writer is not None:
            writer.close()
        return written


def _overlay(
    frame: np.ndarray,
    landmarks: np.ndarray,
    angle: np.ndarray,
    centroid: np.ndarray,
) -> np.ndarray:
    """Raw landmark cloud + heading drawn onto the frame (uint8 RGB).

    Equivalent to the reference's head_pose_plotter(frame, face_info)
    overlay (landmark_estimation.py:134-139): the raw normalized
    landmarks ARE the posed cloud, so the shared plotter is invoked with
    repose_face=False and only the heading comes from the estimated pose.
    """
    from multimodalreactiongeneration_tpu_torch.infer.visualize import (
        head_pose_plotter,
    )

    return head_pose_plotter(
        np.ascontiguousarray(frame).astype(np.uint8),
        {"face": landmarks, "centroid": centroid, "angle": angle},
        repose_face=False,
    )


def _head_path(output_dir: str, name: str, idx: int) -> str:
    return os.path.join(
        output_dir, f"{name}_{str(idx).zfill(ZERO_PADDING)}.head"
    )


def estimate_and_stamp(
    video: VideoSource,
    output_dir: str,
    name: str,
    landmarker: Optional[Landmarker] = None,
    estimate_fps: float = 25.0,
    redo: bool = False,
    device=None,
) -> int:
    """Full L1 step: estimate poses, then compute+stamp corpus statistics."""
    from multimodalreactiongeneration_tpu_torch.corpus.ops import stamp_statistics

    est = HeadPoseEstimation(landmarker, estimate_fps, redo=redo,
                             device=device)
    n = est(video, output_dir, name)
    stamp_statistics(output_dir)
    return n


def process_corpus(
    target: str,
    output: str,
    est_fps: float = 25.0,
    redo: bool = False,
    visualize: str = "none",
    pnum: int = 1,
    landmarker: Optional[Landmarker] = None,
    open_video_fn=None,
    movie_name: str = "movie.mp4",
    device=None,
) -> int:
    """Corpus-level L1 driver (reference video_process.py:27-75 +
    video_process.sh): for every session's side-by-side movie, split into
    comp (left) / host (right) streams (split_frame) and estimate head poses into
    <output>/<session>/{host,comp}_*.head with corpus statistics stamped.

    Head files land in <output>/<session>/<who>/<who>_NNNNN.head with
    per-participant statistics — the layout extract_angle_cent's
    collect_angle_cent consumes.

    The reference materializes host.mp4/comp.mp4 first and re-reads them;
    here the halves are split in-stream (no intermediate encodes).
    ``visualize``: "none" | "sample" (first session per pnum bucket) |
    "all" — renders landmark-overlay movies like the reference's flag.
    Returns total frames estimated.
    """
    import threading

    from multimodalreactiongeneration_tpu_torch.corpus.ops import stamp_statistics
    from multimodalreactiongeneration_tpu_torch.corpus.video import open_video
    from multimodalreactiongeneration_tpu_torch.utils.parallel import (
        parallel_launcher,
    )

    device = resolve_device(device)
    if visualize not in ("none", "sample", "all"):
        raise ValueError(
            f"visualize must be 'all', 'sample' or 'none', not {visualize}"
        )
    open_video_fn = open_video_fn or open_video
    sessions = sorted(
        d for d in os.listdir(target)
        if os.path.isfile(os.path.join(target, d, movie_name))
    )

    # a caller-supplied detector is shared across worker threads, and
    # detectors like mediapipe are not thread-safe: serialize its calls
    # (lazy per-estimator detectors — landmarker=None — stay lock-free)
    if landmarker is not None and pnum > 1:
        inner, lock = landmarker, threading.Lock()

        def landmarker(frame, _inner=inner, _lock=lock):  # noqa: F811
            with _lock:
                return _inner(frame)

    def one_session(i: int, session: str) -> int:
        viz = visualize == "all" or (
            visualize == "sample" and i % max(pnum, 1) == 0
        )
        written = 0
        for side, who in ((0, "comp"), (1, "host")):
            out_who = os.path.join(output, session, who)
            video = HalfVideoSource(
                open_video_fn(os.path.join(target, session, movie_name)),
                side,
            )
            est = HeadPoseEstimation(
                landmarker, est_fps, redo=redo, visualize=viz, device=device
            )
            written += est(video, out_who, who)
            stamp_statistics(out_who)
        return written

    results = parallel_launcher(
        one_session, list(enumerate(sessions)), n_jobs=pnum, unpack=True
    )
    return sum(results)


def main(argv=None, *, landmarker: Optional[Landmarker] = None,
         open_video_fn=None):
    """python -m multimodalreactiongeneration_tpu_torch.corpus.landmarks \\
        --target raw_corpus/ --output features/ [--est-fps 25] [--redo]
        [--pnum 8] [--visualize {none,sample,all}] [--device cpu]"""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--target", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--est-fps", type=float, default=25.0)
    ap.add_argument("--redo", action="store_true")
    ap.add_argument("--pnum", type=int, default=1)
    ap.add_argument("--visualize", default="none",
                    choices=("none", "sample", "all"))
    ap.add_argument("--device", default=None,
                    help="where the poses are computed (default cuda:0)")
    args = ap.parse_args(argv)
    n = process_corpus(
        args.target, args.output, args.est_fps, args.redo,
        args.visualize, args.pnum, landmarker=landmarker,
        open_video_fn=open_video_fn, device=args.device,
    )
    print(f"estimated {n} frames")


if __name__ == "__main__":
    main()
