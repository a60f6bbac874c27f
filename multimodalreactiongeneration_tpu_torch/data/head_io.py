"""Head-pose frame IO: our own format + reference .head compatibility.

A copy of ``multimodalreactiongeneration_tpu/data/head_io.py`` (the
port imports nothing of the JAX package).

The reference pickles per-frame FaceAdapter objects
(reference mr_gen/utils/io.py:121-153, adapter.py:8-42) as
``(frame_index, FaceAdapter-or-None)`` files named
``<dir>_<idx zfill 5>.head``. Unpickling those normally requires mediapipe;
the shim Unpickler below maps the reference's class path onto a plain
container so existing corpora (e.g. data/sample.head) load without torch
or mediapipe installed.

Our own writer uses the same tuple layout and filename convention so the
two ecosystems interoperate bidirectionally.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

ZERO_PADDING = 5


@dataclass
class HeadFrame:
    """Plain-data stand-in for the reference FaceAdapter (adapter.py:8-42)."""

    face: Optional[np.ndarray] = None  # (478, 3) de-rotated, centered
    nose: Optional[np.ndarray] = None
    centroid: Optional[np.ndarray] = None
    angle: Optional[np.ndarray] = None  # degrees, xyz order
    R: Optional[np.ndarray] = None
    resolution: Tuple[int, int] = (0, 0)
    time: float = 0.0
    frame_no: int = 0
    fps: float = 0.0
    angle_mean: np.ndarray = field(default_factory=lambda: np.zeros(3))
    angle_std: np.ndarray = field(default_factory=lambda: np.zeros(3))
    centroid_mean: np.ndarray = field(default_factory=lambda: np.zeros(3))
    centroid_std: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def __setstate__(self, state):
        # FaceAdapter pickles its __dict__; adopt it verbatim
        self.__dict__.update(state)


class _ShimUnpickler(pickle.Unpickler):
    _ALIASES = {
        ("mr_gen.utils.tools.adapter", "FaceAdapter"): HeadFrame,
    }

    def find_class(self, module, name):
        if (module, name) in self._ALIASES:
            return HeadFrame
        return super().find_class(module, name)


def load_head_file(path: str):
    """Read a .head file -> (frame_index, HeadFrame-or-None)."""
    with open(path, "rb") as f:
        obj = _ShimUnpickler(f).load()
    if isinstance(obj, tuple):
        return obj
    # some reference patch scripts wrote bare adapters (patch_for_save)
    return (getattr(obj, "frame_no", 0), obj)


def load_head_frame(path: str) -> HeadFrame:
    idx, frame = load_head_file(path)
    if frame is None:
        raise ValueError(f"{path}: frame {idx} has no detected face")
    return frame


def loads_head(data: bytes):
    return _ShimUnpickler(io.BytesIO(data)).load()


def write_head_frame(path: str, frame_index: int, frame: Optional[HeadFrame]):
    """Write reference-layout (idx, frame) pickle (io.py:121-153)."""
    with open(path, "wb") as f:
        pickle.dump((frame_index, frame), f)
