"""WAV IO without external audio libraries.

A copy of ``multimodalreactiongeneration_tpu/utils/wavio.py``.

Replaces the reference's torchaudio-soundfile loads (audio.py:26,
speech_segmentation.py:351-352) and raw wave reader (io.py:156-167) with a
numpy memory-mapped reader. PCM16 samples scale to float32 by 1/2**15,
matching soundfile/stereo_wav_maker (stereo_wav_maker.py:14-15).

Sliced reads (``start``/``frames``) mirror torchaudio's
``load(path, frame_offset, num_frames)`` so manifest offsets transfer 1:1.
"""

from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np

PCM16_SCALE = 1.0 / 32768.0


def wav_info(path: str) -> Tuple[int, int, int]:
    """Return (sample_rate, num_frames, num_channels)."""
    with wave.open(path, "rb") as w:
        return w.getframerate(), w.getnframes(), w.getnchannels()


def read_wav(
    path: str,
    start: int = 0,
    frames: int = -1,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """Read PCM16 WAV as float32 in [-1, 1), shape (channels, frames).

    ``frames == -1`` reads to EOF. Matches torchaudio soundfile backend
    semantics used by AudioPreprocessor (reference audio.py:24-26), where the
    slice is [start, start+frames).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        if width != 2:
            raise ValueError(f"only PCM16 wavs supported, got width={width}")
        if start:
            w.setpos(min(start, total))
        n = total - start if frames == -1 else min(frames, total - start)
        raw = w.readframes(max(n, 0))
    data = np.frombuffer(raw, dtype="<i2").reshape(-1, nch).T
    if dtype == np.int16:
        return np.ascontiguousarray(data), sr
    return np.ascontiguousarray(data.astype(np.float32) * PCM16_SCALE), sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float (or int16) array of shape (channels, frames) as PCM16."""
    if data.ndim == 1:
        data = data[None, :]
    if data.dtype != np.int16:
        data = np.clip(data * 32768.0, -32768, 32767).astype(np.int16)
    nch = data.shape[0]
    interleaved = np.ascontiguousarray(data.T).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(interleaved)


def memmap_wav(path: str) -> Tuple[np.memmap, int, int]:
    """Memory-map a PCM16 wav's sample payload (zero-copy host pipeline).

    Returns (int16 memmap of shape [frames, channels], sample_rate, channels).
    Used by the databuild/VAD host pipeline to slice long dialogs without
    reading whole files.
    """
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        sr = None
        nch = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                raise ValueError(f"{path}: no data chunk found")
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                (_, nch, sr, _, _, bits) = struct.unpack("<HHIIHH", fmt[:16])
                if bits != 16:
                    raise ValueError(f"{path}: only PCM16 supported")
            elif cid == b"data":
                offset = f.tell()
                frames = size // (2 * (nch or 1))
                break
            else:
                f.seek(size + (size & 1), 1)
    if sr is None or nch is None:
        raise ValueError(f"{path}: missing fmt chunk")
    mm = np.memmap(path, dtype="<i2", mode="r", offset=offset, shape=(frames, nch))
    return mm, sr, nch
