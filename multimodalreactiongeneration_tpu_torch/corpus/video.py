"""Video sources: frames of a movie, an image directory or an array.

Counterpart of ``multimodalreactiongeneration_tpu/corpus/video.py``
(numpy only, copied so the port imports nothing of the JAX package;
reference mr_gen/utils/video.py). Three sources share one protocol:
  * Cv2VideoReader: a movie file through cv2, imported when the reader
    is made (same semantics as the reference's VideoReader: iteration,
    random access by a seek);
  * ImageSequenceReader: frames from a PNG/JPG directory (PIL);
  * ArrayVideoReader: frames from a (T, H, W, C) array or ``.npy`` file.

``open_video`` picks one for a path or an array; ``HalfVideoSource`` is
one participant's half of a side-by-side session movie, and
``split_frame`` halves a frame (reference video_process.py:27-49
_video_div). The eval CLI composes the partner's frames from them
(``infer/cli.py``).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


class VideoSource:
    """Iteration protocol: frames as uint8 (H, W, C) + fps/size metadata."""

    fps: float = 25.0
    size: Tuple[int, int] = (0, 0)  # (w, h)

    def __iter__(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class ArrayVideoReader(VideoSource):
    def __init__(self, frames: np.ndarray, fps: float = 25.0):
        self.frames = frames
        self.fps = fps
        self.size = (frames.shape[2], frames.shape[1])

    def __iter__(self):
        return iter(self.frames)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.frames[idx]

    def __len__(self):
        return len(self.frames)


class ImageSequenceReader(VideoSource):
    def __init__(self, directory: str, fps: float = 25.0):
        from PIL import Image  # noqa: F401  (availability check)

        self.directory = directory
        self.files = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        self.fps = fps
        if self.files:
            from PIL import Image

            with Image.open(self.files[0]) as im:
                self.size = im.size

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.files[idx]) as im:
            return np.asarray(im.convert("RGB"))

    def __iter__(self):
        from PIL import Image

        for path in self.files:
            with Image.open(path) as im:
                yield np.asarray(im.convert("RGB"))

    def __len__(self):
        return len(self.files)


class Cv2VideoReader(VideoSource):
    def __init__(self, path: str):
        try:
            import cv2
        except ImportError as exc:
            raise ImportError(
                "cv2 is not installed; use ImageSequenceReader or "
                "ArrayVideoReader, or install opencv-python"
            ) from exc
        self._cv2 = cv2
        self.path = path
        cap = cv2.VideoCapture(path)
        self.fps = cap.get(cv2.CAP_PROP_FPS)
        self.size = (
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
        self._count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()

    def __iter__(self):
        cap = self._cv2.VideoCapture(self.path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[..., ::-1]  # BGR -> RGB
        finally:
            cap.release()

    def __getitem__(self, idx: int) -> np.ndarray:
        """Random access via a cv2 seek (the reference's per-frame
        `video_reader[i]` pattern, visualize_metaformer.py:287).

        One capture is cached across calls — eval renders hundreds of
        frames per segment and reopening the container each time costs a
        header parse + keyframe seek per frame. Sequential reads (the
        common render pattern) skip the seek entirely."""
        idx = int(idx)
        cap = getattr(self, "_cap", None)
        if cap is None:
            cap = self._cap = self._cv2.VideoCapture(self.path)
            self._cap_next = -1
        if idx != self._cap_next:
            cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = cap.read()
        if not ok:
            self.close()
            raise IndexError(f"frame {idx} past EOF of {self.path}")
        self._cap_next = idx + 1
        return frame[..., ::-1]

    def close(self):
        cap = getattr(self, "_cap", None)
        if cap is not None:
            cap.release()
            self._cap = None

    def __del__(self):  # best-effort; close() is the real API
        self.close()

    def __len__(self):
        return self._count


def open_video(path_or_array, fps: float = 25.0) -> VideoSource:
    if isinstance(path_or_array, np.ndarray):
        return ArrayVideoReader(path_or_array, fps)
    if os.path.isdir(path_or_array):
        return ImageSequenceReader(path_or_array, fps)
    if str(path_or_array).endswith(".npy"):
        return ArrayVideoReader(np.load(path_or_array), fps)
    return Cv2VideoReader(path_or_array)


class HalfVideoSource(VideoSource):
    """View of one participant's half of a side-by-side session movie.

    Lets eval compose source frames directly from ``movie.mp4`` when no
    pre-split comp/host streams exist (the corpus tools' landmark pass splits
    in-stream and never materializes them)."""

    def __init__(self, source: VideoSource, side: int):
        self.source = source
        self.side = side  # 0 = left/comp, 1 = right/host (split_frame)
        self.fps = source.fps
        w, h = source.size
        self.size = (w // 2, h)

    def __iter__(self):
        for frame in self.source:
            yield split_frame(frame)[self.side]

    def __getitem__(self, idx: int) -> np.ndarray:
        return split_frame(self.source[idx])[self.side]

    def __len__(self):
        return len(self.source)


def split_frame(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Side-by-side dialog frame -> (comp, host) halves.

    Reference _video_div (video_process.py:27-49): the LEFT half is the
    comp participant, the RIGHT half is the host; odd widths drop the
    middle column like the reference's [0:half] / [-half:] slicing."""
    half = frame.shape[1] // 2
    return frame[:, :half], frame[:, -half:]
