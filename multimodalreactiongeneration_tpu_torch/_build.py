"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/lib<name>-<hash>.so`` (plain C interface, no PyTorch headers, so
a build takes seconds). The hash covers the source, the headers of
``csrc/`` and the flags: an
edited source builds anew, an unchanged one loads the library already
built. Nothing here runs at import time; the kernel wrappers call
``load`` on their first launch. A measuring tool may ask for a variant
of a source built with preprocessor ``defines`` (an instrumented
build); it gets a library of its own, and the wrappers never ask for
one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, else /usr/local/cuda/bin, else PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or install the CUDA toolkit under "
        "/usr/local/cuda); the CUDA kernels cannot be built"
    )


def _flags(defines: Tuple[str, ...]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    # the headers of csrc/ count too: a .cu may include any of them
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Compile csrc/<name>.cu (with -D for each of ``defines``) unless a
    library for this source exists. The compiler's register/spill report
    goes to _build/<name>.log (<name>-<defines>.log for a variant)."""
    out = _lib_path(name, defines)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [find_nvcc(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = "-".join((name, *defines))
    (BUILD_DIR / f"{log}.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            + proc.stderr[-4000:]
        )
    os.replace(tmp, out)
    return out


def build_all(names) -> Dict[str, float]:
    """Build several sources at once, one nvcc each, all started
    together; returns the seconds each took."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    key = (name, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, key[1])))
            _LIBS[key] = lib
        return lib


def launch(fn, *tensors, dims) -> None:
    """Call a kernel entry point of a loaded library on the current stream
    of the first tensor's device: the tensors' data pointers (None passes
    a null pointer), then ``dims``, then the stream. Raises on a CUDA
    error code."""
    import torch

    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[None if t is None else t.data_ptr() for t in tensors],
                *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
