"""Kinematic bicycle and clamped simulator plant on torch tensors.

Port of ``mpc_for_av_at_intersection_tpu/core/dynamics.py``:
- ``bicycle_step``/``bicycle_rollout``: the forward-Euler rear-axle
  kinematic bicycle of reference ``main/bicycle/main.py:28-41``;
- ``plant_step``/``plant_rollout``: the closed-loop plant of reference
  ``main/lib/simulation.py:35-47``. Steering is clamped, position and
  heading integrate with the *pre-update* velocity, then the velocity is
  updated by the acceleration and clamped (a reference quirk kept on
  purpose).

State layout: (..., 4) = (x, y, v, yaw). Control: (..., 2) = (a, delta).
Pose layout: (..., 3) = (x, y, theta).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SimLimits:
    """Actuation/plant limits (reference ``simulation.py:23-25``,
    ``config/mpc_config.json``)."""

    max_steer: float = math.radians(45.0)
    max_speed: float = 30.0 / 3.6
    min_speed: float = -5.0
    max_accel: float = 2.0
    max_decel: float = -10.0
    max_dsteer: float = math.radians(30.0)  # steering-rate limit [rad/s]


def bicycle_step(pose, v, delta, dt: float, wheelbase: float):
    """One Euler step of the kinematic bicycle. pose (..., 3); v, delta
    scalars or tensors broadcastable against pose[..., 0]."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    x = x + v * torch.cos(th) * dt
    y = y + v * torch.sin(th) * dt
    th = th + (v / wheelbase) * torch.tan(torch.as_tensor(delta, dtype=pose.dtype,
                                                          device=pose.device)) * dt
    return torch.stack([x, y, th], dim=-1)


def bicycle_rollout(pose0, v, delta, dt: float, wheelbase: float, n_steps: int):
    """Constant-control rollout. Returns (n_steps+1, ..., 3) including
    pose0, the step axis first as in the JAX package."""
    poses = [pose0]
    for _ in range(n_steps):
        poses.append(bicycle_step(poses[-1], v, delta, dt, wheelbase))
    return torch.stack(poses, dim=0)


def plant_step(state, control, dt: float, wheelbase: float, limits: SimLimits):
    """Clamped plant update. state (..., 4); control (..., 2)."""
    a, delta = control[..., 0], control[..., 1]
    delta = torch.clamp(delta, -limits.max_steer, limits.max_steer)
    x, y, v, yaw = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    # position/heading integrate with the pre-update velocity
    x = x + v * torch.cos(yaw) * dt
    y = y + v * torch.sin(yaw) * dt
    yaw = yaw + (v / wheelbase) * torch.tan(delta) * dt
    v = torch.clamp(v + a * dt, limits.min_speed, limits.max_speed)
    return torch.stack([x, y, v, yaw], dim=-1)


def plant_rollout(state0, controls, dt: float, wheelbase: float, limits: SimLimits):
    """Roll the plant through a control sequence whose step axis is -2:
    state0 (..., 4), controls (..., T, 2) -> states (..., T+1, 4) including
    state0 (the nonlinear operating-point rollout of reference
    ``mpc.py:112-126``)."""
    states = [state0]
    for t in range(controls.shape[-2]):
        states.append(plant_step(states[-1], controls[..., t, :], dt, wheelbase, limits))
    return torch.stack(states, dim=-2)
