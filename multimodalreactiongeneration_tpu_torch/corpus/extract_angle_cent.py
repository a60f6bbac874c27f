"""Convert per-frame .head pickles into per-segment .npz trajectories.

A copy of ``multimodalreactiongeneration_tpu/corpus/extract_angle_cent.py``
on the port's head IO. Behavior-matched to the reference's
data/extract_angle_cent.py:
  * per session/{comp,host} dir, read <who>_<idx>.head sequentially
    until the first missing index (collect_head_seq :41-93)
  * standardize angle/centroid by the stamped corpus stats (:77-78)
  * linearly interpolate detection gaps shorter than FIX_SIZE=10 frames
    (fix_data :96-128); a gap at the start stays a split. NOTE the
    reference's interpolant runs from the gap-END value a to a+(a-prev)
    (outside the gap endpoints, extract_angle_cent.py:118); as the JAX
    package, this implements the evident intent prev + t*(a-prev)
    (documented deviation, PARITY.md)
  * split at remaining gaps, keep segments >= MIN_DATA_SIZE=100 frames,
    save angle/centroid/stats/section=[start, stop) npz (output_npz
    :131-161), copy the wav alongside (:163-166)

CLI: python -m multimodalreactiongeneration_tpu_torch.corpus.extract_angle_cent
     --path <features_root> --output <npz_root> [--device cpu]
(host file work; ``--device`` as every entry point of the port: the card
unless it names one, raising without CUDA when it names none)
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from multimodalreactiongeneration_tpu_torch import resolve_device
from multimodalreactiongeneration_tpu_torch.data.head_io import load_head_file

ZERO_PADDING = 5
FIX_SIZE = 10
MIN_DATA_SIZE = 100


def collect_head_seq(who_dir: str, who: str) -> Dict[str, list]:
    out = {
        "angle": [],
        "centroid": [],
        "angle_mean": None,
        "angle_std": None,
        "centroid_mean": None,
        "centroid_std": None,
    }
    index = 0
    while True:
        path = os.path.join(
            who_dir, f"{who}_{str(index).zfill(ZERO_PADDING)}.head"
        )
        if not os.path.isfile(path):
            break
        _, head = load_head_file(path)
        if head is not None:
            out["angle_mean"] = head.angle_mean
            out["angle_std"] = head.angle_std
            out["centroid_mean"] = head.centroid_mean
            out["centroid_std"] = head.centroid_std
            out["angle"].append((head.angle - head.angle_mean) / head.angle_std)
            out["centroid"].append(
                (head.centroid - head.centroid_mean) / head.centroid_std
            )
        else:
            out["angle"].append(None)
            out["centroid"].append(None)
        index += 1
    return out


def fix_data(angle_centroid: Dict[str, list]) -> Dict[str, list]:
    """Interpolate short gaps in place (reference :96-128, intent-fixed)."""
    angle: List[Optional[np.ndarray]] = angle_centroid["angle"]
    centroid = angle_centroid["centroid"]

    none_count = 0
    for i, (a, c) in enumerate(zip(angle, centroid)):
        if (a is None) != (c is None):
            raise ValueError("Invalid data: angle/centroid None mismatch")
        if a is None:
            none_count += 1
            continue
        if i - none_count == 0:  # gap touches the start: leave split
            none_count = 0
            continue
        if none_count == 0:
            continue
        if none_count < FIX_SIZE:
            prev_a = angle[i - none_count - 1]
            prev_c = centroid[i - none_count - 1]
            t = np.linspace(0, 1, 1 + none_count + 1)[1:-1]
            ip_a = prev_a + t[:, None] * (a - prev_a)[None, :]
            ip_c = prev_c + t[:, None] * (c - prev_c)[None, :]
            angle[i - none_count : i] = list(ip_a)
            centroid[i - none_count : i] = list(ip_c)
        none_count = 0
    return angle_centroid


def output_npz(base_output_name: str, angle_centroid: Dict[str, list]):
    angles = angle_centroid["angle"]
    start, stop = 0, 1
    max_idx = len(angles) - 1
    for i, element in enumerate(angles):
        if element is None or i == max_idx:
            if element is not None and i == max_idx:
                stop = i + 1
            if stop - start < MIN_DATA_SIZE:
                start = i + 1
                continue
            name = (
                f"{base_output_name}_{str(start).zfill(ZERO_PADDING)}"
                f"_{str(stop).zfill(ZERO_PADDING)}.npz"
            )
            np.savez(
                name,
                angle=np.stack(angles[start:stop]),
                centroid=np.stack(angle_centroid["centroid"][start:stop]),
                angle_mean=angle_centroid["angle_mean"],
                angle_std=angle_centroid["angle_std"],
                centroid_mean=angle_centroid["centroid_mean"],
                centroid_std=angle_centroid["centroid_std"],
                section=np.array([start, stop]),
            )
            start = i + 1
            continue
        stop = i + 1


def collect_angle_cent(root: str, out_root: str):
    os.makedirs(out_root, exist_ok=True)
    for session in sorted(os.listdir(root)):
        data_path = os.path.join(root, session)
        if not os.path.isdir(data_path):
            continue
        out_session = os.path.join(out_root, session)
        os.makedirs(out_session, exist_ok=True)
        for who in ("comp", "host"):
            who_dir = os.path.join(data_path, who)
            if not os.path.isdir(who_dir):
                continue
            seq = fix_data(collect_head_seq(who_dir, who))
            output_npz(os.path.join(out_session, who), seq)
            wav = os.path.join(data_path, who + ".wav")
            if os.path.exists(wav):
                shutil.copy(wav, os.path.join(out_session, who + ".wav"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--path", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default=None,
                        help="the port's device (default cuda:0)")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    collect_angle_cent(args.path, args.output)


if __name__ == "__main__":
    main()
