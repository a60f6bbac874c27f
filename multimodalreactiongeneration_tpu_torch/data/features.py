"""Feature preprocessing: audio fbank and motion trajectory extractors.

Counterpart of ``multimodalreactiongeneration_tpu/data/features.py``.
Behavior-matched to the reference's mr_gen/utils/preprocess/:
  * AudioFeatureExtractor == AudioPreprocessor (audio.py:6-67): wav slice
    [start, end) -> log-mel + log-power + deltas through ``ops/dsp.py``
    (on the CPU: one sample's features are a host-side job);
  * MotionFeatureExtractorNX == MotionPreprocessorNX (motion_nx.py:6-58):
    .npz angle/centroid slices with the ``start += stride - 1`` phase
    shift, optional de-standardization when train_by_std is False,
    concat [angle, centroid], delta stacking;
  * MotionFeatureExtractor == MotionPreprocessor v1 (motion.py:9-66):
    per-frame .head pickles, standardization by stored stats, concat
    [centroid, angle], delta stacking.
They return numpy arrays; the batched on-device fbank of the training
loaders is ``ops/dsp.py batched_logmel_masked``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

import torch

from multimodalreactiongeneration_tpu_torch.data.head_io import load_head_frame
from multimodalreactiongeneration_tpu_torch.ops import dsp
from multimodalreactiongeneration_tpu_torch.utils.wavio import read_wav

ZERO_PADDING = 5  # reference mr_gen/utils/io.py:85


def delta_stack_np(feat: np.ndarray, delta_order: int) -> np.ndarray:
    if delta_order == 0:
        return feat
    d1 = feat[1:] - feat[:-1]
    if delta_order == 1:
        return np.concatenate([feat[1:], d1], axis=-1)
    if delta_order == 2:
        d2 = d1[1:] - d1[:-1]
        return np.concatenate([feat[2:], d1[1:], d2], axis=-1)
    raise ValueError("delta_order must be 0, 1 or 2")


class AudioFeatureExtractor:
    """cfg: audio group (sample_rate, nfft, shift, nmels, delta_order)."""

    def __init__(self, cfg):
        self.sample_rate = cfg["sample_rate"]
        self.params = dsp.FbankParams(
            sample_rate=cfg["sample_rate"],
            n_fft=cfg["nfft"],
            hop=cfg["shift"],
            n_mels=cfg["nmels"],
            delta_order=cfg["delta_order"],
        )

    def __call__(self, wavpath: str, start: int, end: int) -> np.ndarray:
        length = end if end == -1 else end - start
        wave, sr = read_wav(wavpath, start, length)
        if sr != self.sample_rate:
            raise ValueError("sample_rate must match the configured rate")
        feat = dsp.logmel_with_power(torch.from_numpy(wave[0]),
                                     self.params).numpy()
        assert len(feat) != 0, f"start: {start}, end: {end}"
        return feat


class MotionFeatureExtractorNX:
    """cfg: motion group (delta_order, use_centroid, use_angle, train_by_std)."""

    def __init__(self, cfg):
        self.delta_order = cfg["delta_order"]
        self.use_centroid = cfg["use_centroid"]
        self.use_angle = cfg["use_angle"]
        self.train_by_std = cfg["train_by_std"]

    def __call__(
        self, npz_path: str, start: int, end: int, stride: int
    ) -> np.ndarray:
        start += stride - 1
        end += stride - 1
        data = _load_npz(npz_path)
        angle = data["angle"][start:end:stride].copy()
        centroid = data["centroid"][start:end:stride].copy()
        if not self.train_by_std:
            angle *= data["angle_std"]
            angle += data["angle_mean"]
            centroid *= data["centroid_std"]
            centroid += data["centroid_mean"]
        seq = np.concatenate([angle, centroid], axis=-1).astype(np.float32)
        out = delta_stack_np(seq, self.delta_order)
        assert len(out) != 0, (
            f"start: {start}, end: {end}, stride: {stride}, "
            f"len: {len(data['angle'])}\n{npz_path}"
        )
        return out


@functools.lru_cache(maxsize=64)
def _load_npz(path: str):
    """npz archives cached and fully materialized (sessions are small)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class MotionFeatureExtractor:
    """v1 per-frame .head pickle extractor (reference motion.py:9-66)."""

    def __init__(self, cfg):
        self.delta_order = cfg["delta_order"]
        self.use_centroid = cfg["use_centroid"]
        self.use_angle = cfg["use_angle"]

    def __call__(
        self, head_dir: str, start: int, end: int, stride: int
    ) -> np.ndarray:
        base = os.path.split(head_dir)[1]
        records = []
        for idx in range(start, end, stride):
            path = os.path.join(
                head_dir, f"{base}_{str(idx).zfill(ZERO_PADDING)}.head"
            )
            head = load_head_frame(path)
            record = []
            if self.use_centroid:
                record.append(
                    (head.centroid - head.centroid_mean) / head.centroid_std
                )
            if self.use_angle:
                record.append((head.angle - head.angle_mean) / head.angle_std)
            if not record:
                raise ValueError("need use_centroid and/or use_angle")
            records.append(np.concatenate(record, axis=0))
        seq = np.stack(records, axis=0).astype(np.float32)
        return delta_stack_np(seq, self.delta_order)
