"""SE(2) transforms, batched.

Port of ``mpc_for_av_at_intersection_tpu/core/transforms.py`` (capability
parity with reference ``main/lib/linalg.py``'s homogeneous-matrix
transforms), as direct rotate + translate arithmetic.
"""

from __future__ import annotations

import torch


def transform_points_xy(pose, points_xy):
    """Rigidly transform 2-D points into the frame given by ``pose``.

    pose (..., 3) = (x, y, theta), the frame's origin and orientation in
    world space; points_xy (..., N, 2) in the local frame. Returns the
    (..., N, 2) world-space points; the leading dims broadcast.
    """
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    px, py = points_xy[..., 0], points_xy[..., 1]
    wx = c[..., None] * px - s[..., None] * py + x[..., None]
    wy = s[..., None] * px + c[..., None] * py + y[..., None]
    return torch.stack([wx, wy], dim=-1)


def transform_poses(pose, local_poses):
    """Transform (x, y, theta) triplets: rotate + translate xy, add theta
    (reference ``linalg.py:47-49``). pose (..., 3); local_poses (..., N, 3)
    -> (..., N, 3)."""
    xy = transform_points_xy(pose, local_poses[..., :2])
    th = local_poses[..., 2] + pose[..., 2][..., None]
    return torch.cat([xy, th[..., None]], dim=-1)
