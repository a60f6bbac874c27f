"""Euler angles <-> rotation matrices, batched, on tensors or numpy arrays.

Counterpart of ``angles_to_matrix`` and ``matrix_to_angles`` of
``multimodalreactiongeneration_tpu/ops/rotations.py`` (reference
mr_gen/utils/tools/rotations.py:96-293): all 12 orders, angles in
degrees, over any leading batch axes. A torch tensor gives a tensor on
its device, a numpy array (or a list) a numpy array; the dtype is kept
(float32 stays float32, as in the JAX functions).

Parity note: the decomposition uses arctan, not arctan2, as the
reference does (gimbal-unsafe, but it defines the angles the corpus
holds). ``calc_R``, ``centroid`` and ``landmarks_to_pose`` come with the
corpus tools.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi

ORDERS = (
    "xzx", "xyx", "yxy", "yzy", "zyz", "zxz",
    "xyz", "xzy", "yxz", "yzx", "zyx", "zxy",
)


def _ops(x):
    """(array, cos, sin, arctan, stack) for a tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return x, torch.cos, torch.sin, torch.atan, torch.stack
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float64)
    return x, np.cos, np.sin, np.arctan, np.stack


def _rows(order, c1, c2, c3, s1, s2, s3):
    if order == "xyz":
        return (
            (c2 * c3, -c2 * s3, s2),
            (c1 * s3 + c3 * s1 * s2, c1 * c3 - s1 * s2 * s3, -c2 * s1),
            (s1 * s3 - c1 * c3 * s2, c3 * s1 + c1 * s2 * s3, c1 * c2),
        )
    if order == "xzy":
        return (
            (c2 * c3, -s2, c2 * s3),
            (s1 * s3 + c1 * c3 * s2, c1 * c2, c1 * s2 * s3 - c3 * s1),
            (c3 * s1 * s2 - c1 * s3, c2 * s1, c1 * c3 + s1 * s2 * s3),
        )
    if order == "yxz":
        return (
            (c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3, c2 * s1),
            (c2 * s3, c2 * c3, -s2),
            (c1 * s2 * s3 - c3 * s1, c1 * c3 * s2 + s1 * s3, c1 * c2),
        )
    if order == "yzx":
        return (
            (c1 * c2, s1 * s3 - c1 * c3 * s2, c3 * s1 + c1 * s2 * s3),
            (s2, c2 * c3, -c2 * s3),
            (-c2 * s1, c1 * s3 + c3 * s1 * s2, c1 * c3 - s1 * s2 * s3),
        )
    if order == "zyx":
        return (
            (c1 * c2, c1 * s2 * s3 - c3 * s1, s1 * s3 + c1 * c3 * s2),
            (c2 * s1, c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3),
            (-s2, c2 * s3, c2 * c3),
        )
    if order == "zxy":
        return (
            (c1 * c3 - s1 * s2 * s3, -c2 * s1, c1 * s3 + c3 * s1 * s2),
            (c3 * s1 + c1 * s2 * s3, c1 * c2, s1 * s3 - c1 * c3 * s2),
            (-c2 * s3, s2, c2 * c3),
        )
    if order == "xzx":
        return (
            (c2, -c3 * s2, s2 * s3),
            (c1 * s2, c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3),
            (s1 * s2, c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3),
        )
    if order == "xyx":
        return (
            (c2, s2 * s3, c3 * s2),
            (s1 * s2, c1 * c3 - c2 * s1 * s3, -c1 * s3 - c2 * c3 * s1),
            (-c1 * s2, c3 * s1 + c1 * c2 * s3, c1 * c2 * c3 - s1 * s3),
        )
    if order == "yxy":
        return (
            (c1 * c3 - c2 * s1 * s3, s1 * s2, c1 * s3 + c2 * c3 * s1),
            (s2 * s3, c2, -c3 * s2),
            (-c3 * s1 - c1 * c2 * s3, c1 * s2, c1 * c2 * c3 - s1 * s3),
        )
    if order == "yzy":
        return (
            (c1 * c2 * c3 - s1 * s3, -c1 * s2, c3 * s1 + c1 * c2 * s3),
            (c3 * s2, c2, s2 * s3),
            (-c1 * s3 - c2 * c3 * s1, s1 * s2, c1 * c3 - c2 * s1 * s3),
        )
    if order == "zyz":
        return (
            (c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2),
            (c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2),
            (-c3 * s2, s2 * s3, c2),
        )
    if order == "zxz":
        return (
            (c1 * c3 - c2 * s1 * s3, -c1 * s3 - c2 * c3 * s1, s1 * s2),
            (c3 * s1 + c1 * c2 * s3, c1 * c2 * c3 - s1 * s3, -c1 * s2),
            (s2 * s3, c3 * s2, c2),
        )
    raise ValueError(f"invalid order {order!r}")


def angles_to_matrix(angles, order: str = "xyz"):
    """(..., 3) degrees -> (..., 3, 3) rotation matrix (reference :96-212)."""
    angles, cos, sin, _, stack = _ops(angles)
    t = angles * DEG2RAD
    c1, c2, c3 = cos(t[..., 0]), cos(t[..., 1]), cos(t[..., 2])
    s1, s2, s3 = sin(t[..., 0]), sin(t[..., 1]), sin(t[..., 2])
    rows = _rows(order, c1, c2, c3, s1, s2, s3)
    return stack([stack(r, -1) for r in rows], -2)


def matrix_to_angles(m, order: str = "xyz"):
    """(..., 3, 3) -> (..., 3) degrees (reference :215-293, arctan-based)."""
    m, cos, _, arctan, stack = _ops(m)

    def r(i, j):
        return m[..., i - 1, j - 1]

    if order == "xyz":
        t1 = arctan(-r(2, 3) / r(3, 3))
        t2 = arctan(r(1, 3) * cos(t1) / r(3, 3))
        t3 = arctan(-r(1, 2) / r(1, 1))
    elif order == "xzy":
        t1 = arctan(r(3, 2) / r(2, 2))
        t2 = arctan(-r(1, 2) * cos(t1) / r(2, 2))
        t3 = arctan(r(1, 3) / r(1, 1))
    elif order == "yxz":
        t1 = arctan(r(1, 3) / r(3, 3))
        t2 = arctan(-r(2, 3) * cos(t1) / r(3, 3))
        t3 = arctan(r(2, 1) / r(2, 2))
    elif order == "yzx":
        t1 = arctan(-r(3, 1) / r(1, 1))
        t2 = arctan(r(2, 1) * cos(t1) / r(1, 1))
        t3 = arctan(-r(2, 3) / r(2, 2))
    elif order == "zyx":
        t1 = arctan(r(2, 1) / r(1, 1))
        t2 = arctan(-r(3, 1) * cos(t1) / r(1, 1))
        t3 = arctan(r(3, 2) / r(3, 3))
    elif order == "zxy":
        t1 = arctan(-r(1, 2) / r(2, 2))
        t2 = arctan(r(3, 2) * cos(t1) / r(2, 2))
        t3 = arctan(-r(3, 1) / r(3, 3))
    elif order == "xzx":
        t1 = arctan(r(3, 1) / r(2, 1))
        t2 = arctan(r(2, 1) / (r(1, 1) * cos(t1)))
        t3 = arctan(-r(1, 3) / r(1, 2))
    elif order == "xyx":
        t1 = arctan(-r(2, 1) / r(3, 1))
        t2 = arctan(-r(3, 1) / (r(1, 1) * cos(t1)))
        t3 = arctan(r(1, 2) / r(1, 3))
    elif order == "yxy":
        t1 = arctan(r(1, 2) / r(3, 2))
        t2 = arctan(r(3, 2) / (r(2, 2) * cos(t1)))
        t3 = arctan(-r(2, 1) / r(2, 3))
    elif order == "yzy":
        t1 = arctan(-r(3, 2) / r(1, 2))
        t2 = arctan(-r(1, 2) / (r(2, 2) * cos(t1)))
        t3 = arctan(r(2, 3) / r(2, 1))
    elif order == "zyz":
        t1 = arctan(r(2, 3) / r(1, 3))
        t2 = arctan(r(1, 3) / (r(3, 3) * cos(t1)))
        t3 = arctan(-r(3, 2) / r(3, 1))
    elif order == "zxz":
        t1 = arctan(-r(1, 3) / r(2, 3))
        t2 = arctan(-r(2, 3) / (r(3, 3) * cos(t1)))
        t3 = arctan(r(3, 1) / r(3, 2))
    else:
        raise ValueError(f"invalid order {order!r}")
    return stack([t1, t2, t3], -1) * RAD2DEG
