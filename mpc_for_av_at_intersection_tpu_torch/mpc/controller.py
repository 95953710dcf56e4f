"""The single-scenario controller tick, the state it carries, and the QP warm start.

Port of ``mpc_for_av_at_intersection_tpu/mpc/controller.py`` (reference
``main/lib/mpc.py:242-326``): every mutable member of the reference
controller lives in an explicit ``ControllerState`` of tensors, batched
along the leading axis for ``mpc.batch.mpc_step_batched`` and unbatched
for ``mpc_step``. On an unusable solve the controller commands maximum
braking, keeps the previous steering angle and drops both warm starts
(reference mpc.py:294-297).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.angles import hypot
from ..core.curves import take_rows
from .config import MPCConfig

CUDA = torch.device("cuda")


class ControllerState(NamedTuple):
    oa: torch.Tensor          # (B, T) previous planned accelerations
    od: torch.Tensor          # (B, T) previous planned steers
    have_prev: torch.Tensor   # (B,) bool
    ov: torch.Tensor          # (B, T+1) previous planned speeds
    have_ov: torch.Tensor     # (B,) bool
    target_idx: torch.Tensor  # (B,) int32 course localization index
    last_steer: torch.Tensor  # (B,) last commanded steer (kept on failure)
    # cross-tick QP warm start: the previous tick's primal/dual solution and
    # final ADMM penalty, dropped on solve failure like oa/od
    qp_x: torch.Tensor        # (B, n_qp)
    qp_y: torch.Tensor        # (B, m_qp)
    qp_rho: torch.Tensor      # (B,) final ADMM rho (scaled problem)
    have_qp: torch.Tensor     # (B,) bool


class MPCStepOut(NamedTuple):
    accel: torch.Tensor       # (B,) commanded acceleration
    steer: torch.Tensor       # (B,) commanded steering angle
    state: ControllerState
    solved: torch.Tensor      # (B,) bool
    plan_xy: torch.Tensor     # (B, T+1, 2) planned positions (diagnostics)
    xref: torch.Tensor        # (B, 4, T+1)
    target_idx: torch.Tensor  # (B,) int32


_BOOL_FIELDS = ("have_prev", "have_ov", "have_qp")


def init_controller_state(cfg: MPCConfig, dtype=torch.float32, device=CUDA,
                          batch=()) -> ControllerState:
    """Cold controller state; ``batch`` is the leading shape (an int or a
    tuple; () gives the unbatched state of the JAX package). On the card
    unless ``device`` names another."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    T = cfg.T
    n_qp, m_qp = cfg.qp_dims

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return ControllerState(
        oa=zeros(T), od=zeros(T), have_prev=zeros(dt=torch.bool),
        ov=zeros(T + 1), have_ov=zeros(dt=torch.bool),
        target_idx=zeros(dt=torch.int32), last_steer=zeros(),
        qp_x=zeros(n_qp), qp_y=zeros(m_qp),
        qp_rho=torch.full(lead, cfg.admm_rho, dtype=dtype, device=device),
        have_qp=zeros(dt=torch.bool),
    )


def controller_state_from_numpy(d, device=CUDA) -> ControllerState:
    """A ``ControllerState`` from a dict of numpy arrays, e.g. a JAX state as
    ``{k: np.asarray(v) for k, v in cs._asdict().items()}``. Masks become
    bool, ``target_idx`` int32, float rows keep their dtype."""
    fields = {}
    for k in ControllerState._fields:
        t = torch.tensor(np.array(d[k]), device=device)
        if k in _BOOL_FIELDS:
            t = t.to(torch.bool)
        elif k == "target_idx":
            t = t.to(torch.int32)
        fields[k] = t
    return ControllerState(**fields)


def controller_state_to_numpy(cs: ControllerState) -> dict:
    """The reverse of ``controller_state_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in cs._asdict().items()}


def qp_warm_start(cs: ControllerState, cfg: MPCConfig):
    """(x0, y0, rho) warm start for the QP solve from the carried state,
    cold (zeros, rho0) wherever ``have_qp`` is unset; None when warm
    starting is off."""
    if not cfg.warm_start_qp:
        return None
    have = cs.have_qp
    return (
        torch.where(have[:, None], cs.qp_x, torch.zeros_like(cs.qp_x)),
        torch.where(have[:, None], cs.qp_y, torch.zeros_like(cs.qp_y)),
        torch.where(have, cs.qp_rho, torch.full_like(cs.qp_rho, cfg.admm_rho)),
    )


def qp_carry_update(sol, solved, cfg: MPCConfig) -> dict:
    """(qp_x, qp_y, qp_rho, have_qp) for the next tick's state: kept on
    success, dropped to the cold start on failure."""
    ok = solved if cfg.warm_start_qp else torch.zeros_like(solved)
    x = sol.x
    rho = sol.rho if sol.rho is not None else torch.full(
        solved.shape, cfg.admm_rho, dtype=x.dtype, device=x.device)
    return dict(
        qp_x=torch.where(ok[:, None], x, torch.zeros_like(x)),
        qp_y=torch.where(ok[:, None], sol.y, torch.zeros_like(sol.y)),
        qp_rho=torch.where(ok, rho.to(x.dtype), torch.full_like(rho, cfg.admm_rho, dtype=x.dtype)),
        have_qp=ok,
    )


def mpc_step(
    state4,            # (4,) x, y, v, yaw
    course,            # (N, 3) padded course (post-cutoff)
    course_speed,      # (N,) speed channel (speed-ref variant; zeros else)
    valid_len,         # () int32 current (possibly cut) course length
    dl,                # () course tick
    cs: ControllerState,   # unbatched
    cfg: MPCConfig,
    wheelbase: float,
) -> MPCStepOut:
    """One controller tick of one scenario: ``mpc_step_batched`` at B=1,
    so CUDA tensors launch K1 and K2 (A/B-1 without the polish) once per
    re-linearization and CPU tensors run their plain versions. The jerk
    variant (``cfg.jerk``) goes through ``mpc.jerk.mpc_step_jerk``, as in
    the JAX package."""
    if cfg.jerk:
        from .jerk import mpc_step_jerk

        return mpc_step_jerk(state4, course, course_speed, valid_len, dl, cs, cfg, wheelbase)
    return _step_one(state4, course, course_speed, valid_len, dl, cs, cfg, wheelbase)


def _step_one(state4, course, course_speed, valid_len, dl, cs, cfg, wheelbase) -> MPCStepOut:
    """``mpc_step_batched`` on one scenario: every input gets a leading
    batch axis of 1, every output loses it."""
    from .batch import mpc_step_batched   # batch imports ops, whose plain versions import mpc

    out = mpc_step_batched(state4[None], course[None], course_speed[None], valid_len[None],
                           dl[None], ControllerState(*(f[None] for f in cs)), cfg, wheelbase)
    return MPCStepOut(*(ControllerState(*(f[0] for f in v)) if isinstance(v, ControllerState)
                        else v[0] for v in out))


def xref_deviation(state4, course, target_idx):
    """(B,) deviation from the course point at ``target_idx``, with the
    reference's element-wise formula (mpc.py:301-308: the component-wise
    difference times cos and sin of the normal, not a projection)."""
    ref = take_rows(course, target_idx)
    diff = ref[:, :2] - state4[:, :2]
    perp = ref[:, 2] + math.pi / 2.0
    a, b = torch.cos(perp) * diff[:, 0], torch.sin(perp) * diff[:, 1]
    return torch.sqrt(a * a + b * b)


def is_goal(state4, goal_xy, target_idx, valid_len, cfg: MPCConfig):
    """(B,) goal test (reference mpc.py:310-326): near the ORIGINAL course
    end, localized near the end of the CURRENT (possibly cut) course, and
    stopped."""
    near = hypot(state4[:, 0] - goal_xy[:, 0], state4[:, 1] - goal_xy[:, 1]) <= cfg.goal_dist
    at_end = torch.abs(target_idx - valid_len) < 5
    stopped = torch.abs(state4[:, 2]) <= cfg.stop_speed
    return near & at_end & stopped
