"""The batched controller tick: the port's main path.

Port of ``mpc_for_av_at_intersection_tpu/mpc/batch.py::mpc_step_batched``
for the canonical 4-state controller, the jerk variant (``cfg.jerk``: an
accel state, decision vector [u_flat; a0]) and the unpolished controller
(``cfg.polish`` False). Per tick: localize on the course and extract the
velocity-lookahead reference, build the condensed QP (kernel K1: rollout +
linearize + condense), solve it warm-started from the previous tick (kernel
K2: Ruiz + adaptive ADMM + polish; without the polish, kernel A/B-1), and
return the first control with the state for the next tick.
"""

from __future__ import annotations

import torch

from ..ops.admm import solve_box_qp
from ..ops.condense_qp import build_qp
from .config import MPCConfig
from .controller import ControllerState, MPCStepOut, qp_carry_update, qp_warm_start
from .qp import SOLVED_PRIM_MAX
from .reference import compute_reference


def mpc_step_batched(
    states,          # (B, 4)
    courses,         # (B, N, 3)
    course_speeds,   # (B, N)
    valid_lens,      # (B,) int32
    dls,             # (B,)
    cs: ControllerState,
    cfg: MPCConfig,
    wheelbase: float,
) -> MPCStepOut:
    """One controller tick for a batch of scenarios. CUDA tensors run the
    kernels (K1, then K2 or, with ``cfg.polish`` False, A/B-1); CPU tensors
    run their plain versions, in the dtype of the inputs."""
    return _mpc_step(states, courses, course_speeds, valid_lens, dls, cs, cfg,
                     wheelbase, build_qp, solve_box_qp)


def _mpc_step(states, courses, course_speeds, valid_lens, dls, cs, cfg,
              wheelbase, build, solve) -> MPCStepOut:
    """The tick with the QP build and solve passed in: the public entry
    passes the kernel wrappers; ``chip_smoke.py`` passes the plain versions
    to time them on the card. ``solve`` takes ``polish=cfg.polish``."""
    T = cfg.T
    B = states.shape[0]

    oa = torch.where(cs.have_prev[:, None], cs.oa, torch.zeros_like(cs.oa))
    od = torch.where(cs.have_prev[:, None], cs.od, torch.zeros_like(cs.od))
    ov, have_ov, target_idx = cs.ov, cs.have_ov, cs.target_idx
    warm = qp_warm_start(cs, cfg)
    checks, check_iters, s_eps, s_band, s_cap, s_ratio = cfg.solver_schedule

    for _ in range(max(cfg.max_iter, 1)):
        xref, target_idx, reaches_end = compute_reference(
            states, courses, course_speeds, valid_lens, dls, target_idx, ov,
            have_ov, T, cfg.dt, use_speed_channel=cfg.speed_ref)
        cqp = build(states, oa, od, xref, reaches_end, cfg, wheelbase)
        sol = solve(
            cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi, rounds=checks, iters=check_iters,
            rho0=cfg.admm_rho, sigma=cfg.admm_sigma, alpha=cfg.admm_alpha,
            warm=warm, eps=s_eps, refactor_band=s_band, stall_cap=s_cap,
            stall_ratio=s_ratio, ruiz_iters=cfg.admm_ruiz_iters, polish=cfg.polish)
        warm = (sol.x, sol.y, sol.rho) if cfg.warm_start_qp else None
        # the controls are the first 2T decisions (the jerk variant's last is a0)
        oa, od = sol.x[:, :2 * T].reshape(B, T, 2).permute(2, 0, 1).contiguous()
        X = ((cqp.F @ sol.x[..., None])[..., 0] + cqp.g).reshape(B, T, cfg.nx)
        ov = torch.cat([states[:, 2:3], X[:, :, 2]], dim=1)
        have_ov = torch.ones((B,), dtype=torch.bool, device=states.device)

    solved = (torch.isfinite(sol.x).all(1) & torch.isfinite(sol.prim_res)
              & (sol.prim_res < SOLVED_PRIM_MAX))
    # commanded controls clamped to the actuator boxes
    accel = torch.where(solved, torch.clamp(oa[:, 0], cfg.max_decel, cfg.max_accel),
                        torch.full_like(oa[:, 0], cfg.max_decel))
    steer = torch.clamp(torch.where(solved, od[:, 0], cs.last_steer),
                        -cfg.max_steer, cfg.max_steer)
    keep = solved[:, None]
    new_cs = ControllerState(
        oa=torch.where(keep, oa, torch.zeros_like(oa)),
        od=torch.where(keep, od, torch.zeros_like(od)),
        have_prev=solved,
        ov=torch.where(keep, ov, torch.zeros_like(ov)),
        have_ov=solved,
        target_idx=target_idx,
        last_steer=steer,
        **qp_carry_update(sol, solved, cfg),
    )
    plan_xy = torch.cat([states[:, None, :2], X[:, :, :2]], dim=1)
    return MPCStepOut(accel, steer, new_cs, solved, plan_xy, xref, target_idx)
