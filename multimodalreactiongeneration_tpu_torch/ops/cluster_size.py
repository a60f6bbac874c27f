"""CTAs per cluster of the recurrences K8 and K10 (``csrc/lstm_recurrence.cu``,
``csrc/gru.cu``).

A cluster runs 16 batch rows, and a kernel takes one of a few cluster
sizes at each hidden size. A larger cluster gives each CTA fewer units
and a shorter step, but the card holds fewer such clusters at once; a
batch of more clusters than it holds runs in waves, each as long as the
whole chain. ``launch_ctas`` picks the size of a launch from the batch
and the card's own occupancy query.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

ROWS = 16  # batch rows a cluster runs
_RESIDENT = {}  # (kernel, device index, ctas) -> clusters held at once


def cluster_ctas(b: int, sizes: Sequence[int],
                 resident: Callable[[int], int]) -> int:
    """CTAs per cluster for a batch of b rows: the first of ``sizes`` (the
    faster first) at which the card holds all ceil(b / 16) clusters at
    once (``resident(ctas)``: how many it holds), else the last (whose
    clusters then run in waves)."""
    *faster, last = sizes
    for ctas in faster:
        if -(-b // ROWS) <= resident(ctas):
            return ctas
    return last


def launch_ctas(kernel: str, device, b: int, sizes: Sequence[int],
                query: Callable[[int], int]) -> int:
    """``cluster_ctas`` on this CUDA device. ``query(ctas)`` is the kernel
    library's occupancy query (clusters of ``ctas`` CTAs the card holds at
    once); it runs once per (``kernel``, device, ctas), on that device."""
    def resident(ctas):
        key = (kernel, device.index, ctas)
        if key not in _RESIDENT:
            with torch.cuda.device(device):
                _RESIDENT[key] = query(ctas)
        return _RESIDENT[key]
    return cluster_ctas(b, sizes, resident)
