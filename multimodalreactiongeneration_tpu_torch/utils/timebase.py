"""Canonical frame/sample/feature-frame arithmetic.

A copy of ``multimodalreactiongeneration_tpu/utils/timebase.py``.

Every off-by-one-sensitive conversion used across the databuilders,
feature extractors and the streaming session, in one place:

  * audio_offset: extra samples a window needs BEFORE its first motion
    frame so that fbank framing + delta stacking line up
    (reference databuild.py:203, databuild_nx.py:401)
  * motion_offset: the same margin in video frames (databuild_nx.py:402)
  * the ``start += stride - 1`` motion phase shift (motion_nx.py:21-22)
  * fbank frame-count arithmetic (center=False)
"""

from __future__ import annotations

import math


def audio_offset(nfft: int, shift: int, delta_order: int) -> int:
    """Samples of left margin: window overlap + delta warm-up frames."""
    return (nfft - shift) + shift * delta_order


def motion_offset(
    nfft: int, shift: int, delta_order: int, fps: float, sample_rate: int
) -> int:
    """audio_offset expressed in video frames, rounded up."""
    return math.ceil(audio_offset(nfft, shift, delta_order) * fps / sample_rate)


def frame_to_sample(frame: int, sample_rate: int, fps: float) -> int:
    return int(frame * sample_rate / fps)


def num_fbank_frames(num_samples: int, nfft: int, shift: int) -> int:
    """center=False framing (torchaudio/ops.dsp convention)."""
    return (num_samples - nfft) // shift + 1


def num_feature_frames(
    num_samples: int, nfft: int, shift: int, delta_order: int
) -> int:
    """Frames surviving delta stacking."""
    return num_fbank_frames(num_samples, nfft, shift) - delta_order


def motion_phase_start(start: int, stride: int) -> int:
    """The NX motion slice phase shift (motion_nx.py:21-22): slicing
    [start + stride - 1 : end + stride - 1 : stride] aligns strided motion
    frames with the END of each pred_shift group."""
    return start + stride - 1


def delta_margin(delta_order: int, stride: int) -> int:
    """Extra leading motion frames consumed by delta stacking
    (databuild_nx.py:399, databuild.py:245)."""
    return delta_order * stride
