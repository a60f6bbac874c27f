"""Profiling and latency reporting.

Counterpart of ``multimodalreactiongeneration_tpu/utils/profiling.py``,
covering the reference's three ad-hoc mechanisms:
  * speed.log per-rollout wall clock -> ``SpeedLog`` (the file format of
    ``infer/visualize.py generation_speed_log``)
  * measure_time.py micro-benchmarks -> ``timeit``, which synchronizes
    the card around every call
  * torchviz graph PNGs -> ``trace``, a ``torch.profiler`` session that
    writes a Chrome trace, and ``annotate``, a named range in it
    (``torch.profiler.record_function``)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import torch


class SpeedLog:
    """Append per-sample generation wall-clock like the reference
    (visualize_metaformer.py:116-127)."""

    def __init__(self, path: str = "speed.log", reset: bool = True):
        self.path = path
        if reset:
            open(path, "w", encoding="utf-8").close()

    def record(self, seconds: float, frames: int) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(
                f"{seconds:.6f} sec / {frames} frames "
                f"({frames / max(seconds, 1e-9):.1f} frames/s)\n"
            )


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body (host ops, and CUDA kernels where the card is
    there) and write ``<log_dir>/trace.json``, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range that shows up in ``trace``'s timeline."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Median wall-clock seconds of fn(*args), the card synchronized
    before the clock starts and before it stops."""
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
