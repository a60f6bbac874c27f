"""Euler angles <-> rotation matrices, batched, on tensors or numpy arrays.

Counterpart of ``angles_to_matrix`` and ``matrix_to_angles`` of
``multimodalreactiongeneration_tpu/ops/rotations.py`` (reference
mr_gen/utils/tools/rotations.py:96-293): all 12 orders, angles in
degrees, over any leading batch axes. A torch tensor gives a tensor on
its device, a numpy array (or a list) a numpy array; the dtype is kept
(float32 stays float32, as in the JAX functions).

Parity notes:
  * the decomposition uses arctan, not arctan2, as the reference does
    (gimbal-unsafe, but it defines the angles the corpus holds);
  * ``calc_R`` keeps the reference's Gram-Schmidt with its quirk of
    normalizing z by |y| (a no-op numerically, |y| = 1 there;
    reference rotations.py:44-45);
  * landmark indices 33/263 (eye corners), 152 (chin), 10 (forehead):
    MediaPipe FaceMesh canonical points (reference rotations.py:14-17).

``landmarks_to_pose`` is the corpus tools' entry point: a chunk of
frames' landmarks to (angle, centroid) in one batched call on the device
``resolve_device`` gives (the card unless the caller names one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multimodalreactiongeneration_tpu_torch import resolve_device

DEG2RAD = math.pi / 180.0
RAD2DEG = 180.0 / math.pi

LM_EYE_R = 33
LM_EYE_L = 263
LM_CHIN = 152
LM_FOREHEAD = 10

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


def _vec_ops(x):
    """(array, scale vector maker, norm, dot, cross, stack) over the last
    axis, for a tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return (
            x,
            lambda v: torch.tensor(v, dtype=x.dtype, device=x.device),
            lambda v: torch.linalg.vector_norm(v, dim=-1, keepdim=True),
            lambda a, b: (a * b).sum(-1, keepdim=True),
            lambda a, b: torch.linalg.cross(a, b, dim=-1),
            torch.stack,
        )
    x = np.asarray(x)
    return (
        x,
        lambda v: np.asarray(v, dtype=x.dtype),
        lambda v: np.linalg.norm(v, axis=-1, keepdims=True),
        lambda a, b: (a * b).sum(-1, keepdims=True),
        np.cross,
        np.stack,
    )


def calc_R(landmarks, img_w: float, img_h: float):
    """Face-frame rotation matrix from (..., 478, 3) normalized landmarks
    (reference rotations.py:6-49): rows are the face-local x (eye line),
    y (vertical) and z axes in image space. A tensor gives a tensor on its
    device, a numpy array a numpy array."""
    landmarks, vec, norm, dot, cross, stack = _vec_ops(landmarks)
    scale = vec([img_w, img_h, img_w])
    p33 = landmarks[..., LM_EYE_R, :] * scale
    p263 = landmarks[..., LM_EYE_L, :] * scale
    p152 = landmarks[..., LM_CHIN, :] * scale
    p10 = landmarks[..., LM_FOREHEAD, :] * scale

    _x = p263 - p33
    x = _x / norm(_x)
    _y = p152 - p10
    y = _y - x * dot(x, _y)
    y = y / norm(y)
    z = cross(x, y)
    z = z / norm(y)  # the reference's |y|, kept
    return stack([x, y, z], -2)


def centroid(landmarks):
    """Mean landmark = face centroid (reference adapter.py:22-24)."""
    if isinstance(landmarks, torch.Tensor):
        return landmarks.mean(-2)
    return np.asarray(landmarks).mean(-2)


def landmarks_to_pose(landmarks, img_w: float, img_h: float, device=None):
    """(T, 478, 3) landmarks (numpy or a tensor) -> (angle (T, 3) degrees,
    centroid (T, 3)) as float32 tensors on the resolved device.

    The reference runs these per frame inside FaceAdapter.__init__
    (adapter.py:26-33): centroid = mean landmark, the face centered, then
    angle = matrix_to_angles(calc_R(face)). Centering is a translation and
    calc_R reads landmark differences only, so R is unaffected: one
    batched call over a chunk of frames gives both."""
    device = resolve_device(device)
    lms = torch.as_tensor(landmarks, dtype=torch.float32, device=device)
    ang = matrix_to_angles(calc_R(lms, float(img_w), float(img_h)), "xyz")
    return ang, centroid(lms)
