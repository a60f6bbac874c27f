"""Video writing and audio muxing through an ffmpeg subprocess.

Counterpart of ``multimodalreactiongeneration_tpu/infer/video.py``
(reference VideoWriter mr_gen/utils/video.py:134-156, patch_audio
:158-164, cat_audio visualize_metaformer.py:64-85): frames go straight
into one ffmpeg process as rawvideo on its stdin, and the audio mux is a
second, stream-copy invocation; the argv lists are the JAX module's.
The wav slicing reads and writes through the port's ``utils/wavio.py``.

Everything is gated on the ffmpeg binary (``have_ffmpeg()``), and the
encoder command and the runner are injectable, so tests drive the
writer with a fake encoder.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, List, Optional, Sequence, Union

import numpy as np


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _default_encoder_cmd(path: str, fps: float, width: int, height: int):
    """rawvideo-on-stdin -> H.264 mp4, yuv420p for player compatibility."""
    return [
        "ffmpeg",
        "-y",
        "-loglevel", "error",
        "-f", "rawvideo",
        "-pix_fmt", "rgb24",
        "-s", f"{width}x{height}",
        "-r", f"{fps}",
        "-i", "pipe:0",
        "-pix_fmt", "yuv420p",
        "-c:v", "libx264",
        path,
    ]


class FfmpegVideoWriter:
    """Streams RGB uint8 frames into an encoder subprocess.

    Mirrors the reference VideoWriter contract (video.py:147-156): the
    output size is latched from the first frame; ``write`` accepts one
    frame or a list. ``encoder_cmd`` maps (path, fps, w, h) -> argv and
    defaults to ffmpeg; pass a fake for tests or other encoders.
    """

    def __init__(
        self,
        path: str,
        fps: float,
        encoder_cmd: Optional[Callable[..., List[str]]] = None,
    ) -> None:
        if encoder_cmd is None and not have_ffmpeg():
            raise RuntimeError(
                "ffmpeg not found on PATH; install it (the project Docker "
                "image ships it) or render PNG frames instead"
            )
        self._path = path
        self._fps = fps
        self._encoder_cmd = encoder_cmd or _default_encoder_cmd
        self._proc: Optional[subprocess.Popen] = None
        self._size = None  # (w, h)
        self.frames_written = 0

    def _open(self, width: int, height: int) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self._path)), exist_ok=True)
        self._size = (width, height)
        self._proc = subprocess.Popen(
            self._encoder_cmd(self._path, self._fps, width, height),
            stdin=subprocess.PIPE,
        )

    def write(self, frames: Union[np.ndarray, Sequence[np.ndarray]]) -> None:
        if isinstance(frames, np.ndarray) and frames.ndim == 3:
            frames = [frames]
        for frame in frames:
            frame = np.ascontiguousarray(frame)
            if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
                raise ValueError(
                    f"expected (H, W, 3) uint8 RGB frame, got "
                    f"{frame.dtype} {frame.shape}"
                )
            h, w = frame.shape[:2]
            if self._proc is None:
                self._open(w, h)
            elif (w, h) != self._size:
                raise ValueError(
                    f"frame size {(w, h)} != first frame {self._size}"
                )
            self._proc.stdin.write(frame.tobytes())
            self.frames_written += 1

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdin.close()
            rc = self._proc.wait()
            self._proc = None
            if rc != 0:
                raise RuntimeError(f"video encoder exited with rc={rc}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _run_ffmpeg(args: List[str], runner: Callable, what: str) -> None:
    """Invoke ffmpeg through ``runner`` with a clean missing-binary error."""
    if runner is subprocess.run and not have_ffmpeg():
        raise RuntimeError(f"ffmpeg not found on PATH; cannot {what}")
    runner(["ffmpeg", "-y", "-loglevel", "error"] + args, check=True)


def patch_audio(
    out_path: str,
    video_path: str,
    audio_path: str,
    runner: Callable = subprocess.run,
) -> None:
    """Mux an audio file onto a video (reference video.py:158-164).

    Stream-copies the video (no re-encode) and encodes the audio to AAC;
    ``-shortest`` clips to the shorter stream like moviepy's set_audio.
    """
    _run_ffmpeg(
        [
            "-i", video_path,
            "-i", audio_path,
            "-c:v", "copy",
            "-c:a", "aac",
            "-shortest",
            out_path,
        ],
        runner,
        "mux audio",
    )


def trim_video(
    in_path: str,
    out_path: str,
    start_s: float,
    stop_s: float,
    runner: Callable = subprocess.run,
) -> None:
    """Frame-accurate trim of a movie to [start_s, stop_s) seconds.

    The reference trims by frame index through its cv2 reader/writer
    (VideoReader.trime_time, video.py:271-277 + the rewrite loop in
    data_alignment.py:269-287); re-encoding with an output-side -ss/-to
    gives the same frame-accurate result in one process.
    """
    _run_ffmpeg(
        [
            "-i", in_path,
            "-ss", f"{start_s:.6f}",
            "-to", f"{stop_s:.6f}",
            "-c:v", "libx264",
            "-pix_fmt", "yuv420p",
            "-an",
            out_path,
        ],
        runner,
        "trim video",
    )


def cat_audio(
    video_path: str,
    out_path: str,
    audio_path: str,
    start: int,
    stop: int,
    fps: float,
    stride: int,
    runner: Callable = subprocess.run,
) -> str:
    """Slice the dialog wav to the rendered span and mux it onto the video.

    Frame-index -> sample-index conversion matches the reference
    (visualize_metaformer.py:64-85): sample = sr * frame / fps, the slice
    covers [start, stop + stride) video frames. The sliced wav is written
    next to ``out_path`` (same .wav-alongside contract) and then muxed.
    """
    from multimodalreactiongeneration_tpu_torch.utils import wavio

    sr, _, _ = wavio.wav_info(audio_path)
    start_idx = int(sr * start / fps)
    stop_idx = int(sr * (stop + stride) / fps)
    wave, _ = wavio.read_wav(audio_path, start_idx, stop_idx - start_idx)
    wave_out = out_path.rsplit(".", 1)[0] + ".wav"
    wavio.write_wav(wave_out, wave, sr)
    patch_audio(out_path, video_path, wave_out, runner=runner)
    return wave_out
