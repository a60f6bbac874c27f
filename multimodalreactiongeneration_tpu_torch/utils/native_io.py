"""ctypes binding of the native wav IO library (``native/mrgen_io.cpp``).

Counterpart of ``multimodalreactiongeneration_tpu/utils/native_io.py``:
the loader's hot path, n wav slices decoded into one contiguous buffer
per call (float32, or the raw PCM16 samples), and the framed energy of
the VAD (``data/segmentation.py``). The library is built from the
repository's ``native/mrgen_io.cpp`` with ``g++`` at first use into the
port's ``_build/`` (``libmrgen_io-<hash>.so``, keyed by the source and
the flags, as ``_build.py`` keys the CUDA libraries); nothing is written
under ``native/``. Where JAX falls back to its Python reader when the
library is missing, the port raises, naming the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from multimodalreactiongeneration_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mrgen_io.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()

_LONG_P = ctypes.POINTER(ctypes.c_long)
_SIGNATURES = {
    "mrgen_read_f32": (ctypes.c_long, [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]),
    "mrgen_read_batch_f32": (ctypes.c_long, [
        ctypes.c_char_p, _LONG_P, _LONG_P, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]),
    "mrgen_read_batch_i16": (ctypes.c_long, [
        ctypes.c_char_p, _LONG_P, _LONG_P, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_short)]),
    "mrgen_frame_energy": (ctypes.c_long, [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_float)]),
}


def lib_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmrgen_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/mrgen_io.cpp`` unless a library for this source
    exists; raises naming the compiler's error when it cannot."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native IO source missing: {SOURCE}")
    out = lib_path()
    if out.is_file():
        return out
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler ({os.environ.get('CXX') or 'g++'} not found): "
            f"the native wav IO library ({SOURCE.name}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
            + proc.stderr[-4000:])
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built at first use; cached per process."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def read_slice(path: str, start: int, frames: int) -> np.ndarray:
    """Mono float32 slice, zero-padded past EOF (channel 0)."""
    out = np.empty(frames, np.float32)
    rc = load().mrgen_read_f32(
        path.encode(), start, frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc < 0:
        raise OSError(f"native read failed ({rc}) for {path}")
    return out


def _pack_paths(paths: List[str], starts: List[int]):
    blob = b"".join(p.encode() + b"\0" for p in paths)
    offsets = np.zeros(len(paths), np.int64)
    pos = 0
    for i, p in enumerate(paths):
        offsets[i] = pos
        pos += len(p.encode()) + 1
    return blob, offsets, np.asarray(starts, np.int64)


def read_batch(
    paths: List[str], starts: List[int], frames: int, dtype=np.float32
) -> np.ndarray:
    """(n, frames) batch of channel-0 slices in one native call, zero past
    EOF. ``dtype=np.int16`` returns the raw PCM16 samples with no float
    conversion: the loader uploads these and scales by 1/2**15 on the
    device (``ops/dsp.py``), exact in float32, so the batch has the same
    bits at half the bytes."""
    lib = load()
    int16 = np.dtype(dtype) == np.int16
    fn, ctype, out_dtype = (
        (lib.mrgen_read_batch_i16, ctypes.c_short, np.int16) if int16 else
        (lib.mrgen_read_batch_f32, ctypes.c_float, np.float32))
    blob, offsets, starts_arr = _pack_paths(paths, starts)
    out = np.empty((len(paths), frames), out_dtype)
    rc = fn(
        blob,
        offsets.ctypes.data_as(_LONG_P),
        starts_arr.ctypes.data_as(_LONG_P),
        frames,
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctype)),
    )
    if rc != 0:
        raise OSError(f"native batch read failed at segment {-rc - 1} "
                      f"({paths[-rc - 1]})")
    return out


def frame_energy_native(
    wave: np.ndarray, n_fft: int = 400, hop: int = 160
) -> np.ndarray:
    """Framed energy (the sum of squared samples of each n_fft window,
    every hop samples, summed left to right in float32): the VAD's front
    half (``data/segmentation.py compute_log_power``)."""
    lib = load()
    wave = np.ascontiguousarray(wave, np.float32)
    num = max((len(wave) - n_fft) // hop + 1, 0)
    out = np.empty(num, np.float32)
    got = lib.mrgen_frame_energy(
        wave.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wave),
        n_fft,
        hop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out[:got]
