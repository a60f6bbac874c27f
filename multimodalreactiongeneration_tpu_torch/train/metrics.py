"""Per-feature-slice MSE metrics (reference multi_modal_metrics.py:6-56).

Counterpart of ``multimodalreactiongeneration_tpu/train/metrics.py``:
``gen_target_dict`` gives the slice layout shared by the three models
(centroid/angle plus delta1/delta2 slices keyed by feature ranges);
``per_slice_sq_err`` returns (sum_sq_err, count) pairs that stay on the
device; ``MetricAccumulator`` reads them back and averages per epoch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def gen_target_dict(
    use_centroid: bool, use_angle: bool, delta_order: int
) -> Dict[str, Tuple[int, int]]:
    target = {"centroid": (0, 3), "angle": (3, 6)}
    tail = 6
    if not use_centroid:
        target.pop("centroid")
        target["angle"] = (0, 3)
        tail = 3
    elif not use_angle:
        target.pop("angle")
        tail = 3
    if delta_order > 0:
        if use_centroid:
            target["delta1-centroid"] = (tail, tail + 3)
            tail += 3
        if use_angle:
            target["delta1-angle"] = (tail, tail + 3)
            tail += 3
    if delta_order > 1:
        if use_centroid:
            target["delta2-centroid"] = (tail, tail + 3)
            tail += 3
        if use_angle:
            target["delta2-angle"] = (tail, tail + 3)
            tail += 3
    return target


def per_slice_sq_err(
    preds: torch.Tensor,
    target: torch.Tensor,
    target_dict: Dict[str, Tuple[int, int]],
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """(..., D) pred/target -> {name: (sum_sq_err, element_count)};
    divide the sum by the count for the slice's MSE."""
    out = {}
    for name, (start, end) in target_dict.items():
        diff = preds[..., start:end] - target[..., start:end]
        out[name] = (
            torch.sum(torch.square(diff)),
            torch.tensor(float(diff.numel()), device=diff.device),
        )
    return out


class MetricAccumulator:
    """Host-side epoch accumulator with train_/valid_/genrt_ prefixes."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.reset()

    def reset(self) -> None:
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def update(self, slice_errs) -> None:
        for name, (s, c) in slice_errs.items():
            self._sums[name] = self._sums.get(name, 0.0) + float(s)
            self._counts[name] = self._counts.get(name, 0.0) + float(c)

    def compute(self) -> Dict[str, float]:
        return {
            f"{self.prefix}{name}": self._sums[name] / max(self._counts[name], 1.0)
            for name in self._sums
        }
