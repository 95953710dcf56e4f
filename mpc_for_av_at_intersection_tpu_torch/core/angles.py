"""Angle utilities on torch tensors.

Port of ``mpc_for_av_at_intersection_tpu/core/angles.py``. Parity targets:
reference ``main/lib/maths.py:4`` (normalize_angle) and
``main/lib/mpc.py:43-55`` (smooth_yaw).
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi). Elementwise; any shape."""
    theta = torch.remainder(theta, TWO_PI)
    return torch.where(theta >= math.pi, theta - TWO_PI, theta)


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) by the scaled formula of ``jnp.hypot`` (larger leg
    times sqrt(1 + ratio^2)), so that a distance tested against a threshold
    rounds as it does in the JAX package."""
    a, b = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    r = torch.where(hi == 0, hi, hi * torch.sqrt(1 + q * q))
    return torch.where(torch.isinf(a) | torch.isinf(b), torch.full_like(r, float("inf")), r)


def _smooth_step(prev_adj, raw_next):
    """One step of the sequential yaw unwrap: first subtract 2*pi until the
    delta is < pi/2, then add 2*pi until it is > -pi/2 (the phases do not
    alternate). Closed form of both loop counts."""
    d0 = raw_next - prev_adj
    half_pi = math.pi / 2.0
    k = torch.where(d0 >= half_pi, torch.floor((d0 - half_pi) / TWO_PI) + 1.0,
                    torch.zeros_like(d0))
    d1 = d0 - TWO_PI * k
    m = torch.where(d1 <= -half_pi, torch.floor((-half_pi - d1) / TWO_PI) + 1.0,
                    torch.zeros_like(d1))
    return prev_adj + (d1 + TWO_PI * m)


def smooth_yaw(yaw: torch.Tensor, valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sequentially unwrap course yaw along the last axis so consecutive
    deltas avoid +-pi jumps. ``yaw``: (..., N). ``valid_mask``: optional
    (..., N) bool; invalid entries carry the previous adjusted value through
    the recursion and are returned unchanged."""
    if valid_mask is None:
        valid_mask = torch.ones(yaw.shape, dtype=torch.bool, device=yaw.device)
    out = [yaw[..., 0]]
    prev = yaw[..., 0]
    for i in range(1, yaw.shape[-1]):
        adj = _smooth_step(prev, yaw[..., i])
        prev = torch.where(valid_mask[..., i], adj, prev)
        out.append(prev)
    return torch.where(valid_mask, torch.stack(out, dim=-1), yaw)


def smooth_yaw_numpy(yaw):
    """Host-side (NumPy, float64) twin of ``smooth_yaw`` for scenario setup.

    Engine setup smooths the course yaw exactly once, as the reference's
    ``MPC.__init__`` does in place (mpc.py:257)."""
    yaw = np.asarray(yaw, dtype=np.float64).copy()
    half_pi = np.pi / 2.0
    two_pi = 2.0 * np.pi
    for i in range(len(yaw) - 1):
        d = yaw[i + 1] - yaw[i]
        if d >= half_pi:
            yaw[i + 1] -= two_pi * (np.floor((d - half_pi) / two_pi) + 1.0)
            d = yaw[i + 1] - yaw[i]
        if d <= -half_pi:
            yaw[i + 1] += two_pi * (np.floor((-half_pi - d) / two_pi) + 1.0)
    return yaw
