"""Constant-control forward prediction of other agents.

Port of ``mpc_for_av_at_intersection_tpu/agents/prediction.py`` (reference
``main/lib/moving_obstacles_prediction.py:21-47``): Euler rollout under
constant (a, steer), with the reference's quirk that the heading update
uses the *already-updated* velocity (:26-27). The returned trajectory
excludes the initial state, length n_steps = len(arange(0, horizon, dt)).
"""

from __future__ import annotations

import torch


def predict_constant_control(obs6, dt: float, wheelbase: float, n_steps: int):
    """obs6: (..., 6) rows (x, y, v, yaw, a, steer) — the agents_get tuple.

    Returns (..., n_steps, 3) predicted (x, y, yaw).
    """
    x, y, v, yaw, a, steer = obs6.unbind(-1)
    out = []
    for _ in range(n_steps):
        x = x + v * torch.cos(yaw) * dt
        y = y + v * torch.sin(yaw) * dt
        v = v + a * dt
        yaw = yaw + (v / wheelbase) * torch.tan(steer) * dt
        out.append(torch.stack([x, y, yaw], dim=-1))
    return torch.stack(out, dim=-2)
