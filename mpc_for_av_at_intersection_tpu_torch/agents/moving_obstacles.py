"""Scripted moving agents ("other vehicles") as batched tensor functions.

Port of ``mpc_for_av_at_intersection_tpu/agents/moving_obstacles.py``
(reference ``main/lib/moving_obstacles.py``): three policy families —
T-intersection through/turning traffic, roundabout traffic, and straight
arterial riders — each an open-loop steering schedule keyed on the agent's
own position, plus a start-delay ``offset``. Agents are rows of
``AgentStates`` with any leading batch shape; the JAX package's
``lax.switch`` over the policy id becomes a ``torch.where`` over all three
schedules.

Reference quirks reproduced (QUIRKS #6-8):
- the roundabout schedule *teleports the heading* (sets theta hard) on two
  of its zone transitions (moving_obstacles.py:80-81, :103-104);
- the steering-for-radius helper always uses wheelbase 2.86 regardless of
  the agent's geometry (moving_obstacles.py:16 default L);
- the start-delay gate is ``counter > offset/dt`` (strict).

The host-side constructors at the end build numpy rows, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

POLICY_T_INTERSECTION = 0
POLICY_ROUNDABOUT = 1
POLICY_ARTERIAL = 2

_L_STEER_HELPER = 2.86  # reference hard-codes this in the radius helper


def steering_for_radius(radius: float, wheelbase: float = _L_STEER_HELPER) -> float:
    return math.atan(wheelbase / radius)


class AgentParams(NamedTuple):
    """Static per-agent parameters; tensors of shape (..., n_agents)."""

    policy: torch.Tensor      # int32 policy id
    direction: torch.Tensor   # +1 / -1
    turning: torch.Tensor     # bool
    speed: torch.Tensor       # commanded forward speed
    offset: torch.Tensor      # start delay [s]; <= 0 means none
    x_turn: torch.Tensor      # turn trigger abscissa (T-intersection)
    active: torch.Tensor      # bool — padded slots are inactive


class AgentStates(NamedTuple):
    pose: torch.Tensor        # (..., n_agents, 3) x, y, theta
    counter: torch.Tensor     # (..., n_agents) int32 ticks elapsed


_R5 = steering_for_radius(5.0)


def _t_intersection_steer(p: AgentParams, x, th):
    zero = torch.zeros_like(x)
    steer_pos = torch.where((x >= p.x_turn) & (th > -math.pi / 2), -0.38 + zero, zero)
    steer_neg = torch.where((x <= p.x_turn) & (th < 3 * math.pi / 2), 0.19 + zero, zero)
    steer = torch.where(p.direction >= 0, steer_pos, steer_neg)
    return torch.where(p.turning, steer, zero)


def _roundabout_steer(p: AgentParams, x, y, th):
    """(steer, theta after the schedule's heading teleports)."""
    zero = torch.zeros_like(x)
    # direction == +1 (left to right); sequential zone overrides in the
    # reference's order (later rules win)
    s = torch.where((-7.0 <= x) & (x <= -4.0) & (y < 0), -_R5 + zero, zero)
    s = torch.where(-3.0 < x, _R5 + zero, s)
    s = torch.where((y > 0) & (-5.0 <= x) & (x <= -3.0), -_R5 + zero, s)
    tele_pos = (x <= -3.0) & (y > 0)
    s = torch.where(tele_pos, zero, s)
    th_pos = torch.where(tele_pos, -math.pi + zero, th)

    s2 = torch.where((4.0 <= x) & (x <= 7.0) & (y > 0), -_R5 + zero, zero)
    s2 = torch.where(x < 3.0, _R5 + zero, s2)
    s2 = torch.where((y < 0) & (3.0 <= x) & (x <= 5.0), -_R5 + zero, s2)
    tele_neg = (3.0 <= x) & (y < 0)
    s2 = torch.where(tele_neg, zero, s2)
    th_neg = torch.where(tele_neg, zero, th)

    pos_dir = p.direction >= 0
    steer = torch.where(p.turning, torch.where(pos_dir, s, s2), zero)
    new_th = torch.where(p.turning, torch.where(pos_dir, th_pos, th_neg), th)
    return steer, new_th


def _control(p: AgentParams, pose, counter, dt):
    """(speed, steer, pose) of every agent under its policy; the policy id
    is clamped into range as ``lax.switch`` clamps its index."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    policy = torch.clamp(p.policy, POLICY_T_INTERSECTION, POLICY_ARTERIAL)
    s_round, th_round = _roundabout_steer(p, x, y, th)
    steer = torch.where(policy == POLICY_T_INTERSECTION, _t_intersection_steer(p, x, th),
                        torch.where(policy == POLICY_ROUNDABOUT, s_round, th * 0.0))
    th = torch.where(policy == POLICY_ROUNDABOUT, th_round, th)
    pose = torch.stack([x, y, th], dim=-1)
    delayed = (p.offset > 0) & (counter.to(pose.dtype) * dt <= p.offset)
    v = torch.where(delayed, torch.zeros_like(p.speed), p.speed)
    return v, steer, pose


def agents_get(params: AgentParams, states: AgentStates, dt: float):
    """(..., n_agents, 6) rows (x, y, v, yaw, a, steer) — the reference
    ``get()`` tuple (moving_obstacles.py:122-124). Quirk: that tuple is built
    left to right, so the yaw slot is read *before* the steering property
    applies any heading teleport."""
    pose = states.pose
    v, steer, _ = _control(params, pose, states.counter, dt)
    return torch.stack([pose[..., 0], pose[..., 1], v.to(pose.dtype), pose[..., 2],
                        torch.zeros_like(pose[..., 0]), steer.to(pose.dtype)], dim=-1)


def agents_step(params: AgentParams, states: AgentStates, dt: float,
                wheelbase: float) -> AgentStates:
    """Advance every agent one tick (forward-Euler bicycle on its own pose)."""
    v, steer, pose = _control(params, states.pose, states.counter, dt)
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    x = x + v * torch.cos(th) * dt
    y = y + v * torch.sin(th) * dt
    th = th + (v / wheelbase) * torch.tan(steer) * dt
    new_pose = torch.where(params.active[..., None], torch.stack([x, y, th], dim=-1), pose)
    return AgentStates(pose=new_pose, counter=states.counter + 1)


# --- host-side constructors (return (params_row, state_row) as numpy dicts) ---

def _mk(policy, direction, turning, speed, offset, x_turn, pose):
    params = dict(
        policy=np.int32(policy),
        direction=np.float64(direction),
        turning=bool(turning),
        speed=np.float64(speed),
        offset=np.float64(offset if offset is not None else 0.0),
        x_turn=np.float64(x_turn),
        active=True,
    )
    state = dict(pose=np.asarray(pose, np.float64), counter=np.int32(0))
    return params, state


def make_t_intersection_agent(direction: int, turning: bool, speed: float, offset=None):
    """Reference MovingObstacleTIntersection.__init__ (moving_obstacles.py:165-195)."""
    if direction >= 0:
        pose, x_turn = (-30.0, -3.0, 0.0), -10.0
    else:
        pose, x_turn = (30.0, 3.0, math.pi), 12.0
    return _mk(POLICY_T_INTERSECTION, 1 if direction >= 0 else -1, turning, speed, offset,
               x_turn, pose)


def make_roundabout_agent(direction: int, turning: bool, speed: float, offset=None):
    """Reference MovingObstacleRoundabout.__init__ (moving_obstacles.py:28-60)."""
    if direction >= 0:
        pose, x_turn = (-30.0, -3.0, 0.0), -10.0
    else:
        pose, x_turn = (30.0, 3.0, math.pi), 12.0
    return _mk(POLICY_ROUNDABOUT, 1 if direction >= 0 else -1, turning, speed, offset,
               x_turn, pose)


def make_arterial_agent(x_init: float, y_init: float, speed: float, offset=None):
    """Reference MovingObstacleArterial.__init__ (moving_obstacles.py:126-142)."""
    return _mk(POLICY_ARTERIAL, 1, False, speed, offset, 0.0, (x_init, y_init, math.pi / 2))


def stack_agents(rows, n_slots: int, dtype=None):
    """Stack (params_row, state_row) pairs into padded numpy
    AgentParams/AgentStates."""
    dtype = dtype or np.float64
    n = len(rows)
    if n > n_slots:
        raise ValueError(f"{n} agents > {n_slots} slots")

    def field(name, default, dt_):
        vals = [r[0][name] for r in rows] + [default] * (n_slots - n)
        return np.asarray(vals, dt_)

    params = AgentParams(
        policy=field("policy", 0, np.int32),
        direction=field("direction", 1.0, dtype),
        turning=field("turning", False, bool),
        speed=field("speed", 0.0, dtype),
        offset=field("offset", 0.0, dtype),
        x_turn=field("x_turn", 0.0, dtype),
        active=field("active", False, bool),
    )
    poses = [r[1]["pose"] for r in rows] + [np.zeros(3)] * (n_slots - n)
    states = AgentStates(
        pose=np.asarray(poses, dtype),
        counter=np.zeros(n_slots, np.int32),
    )
    return params, states
