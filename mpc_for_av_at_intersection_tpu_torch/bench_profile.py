"""Per-stage profile of the controller tick's steady state.

Port of the repository root's ``bench_profile.py`` (its TPU branch). Each
stage of the batched controller tick at B scenarios, horizon T (n = 2T,
m = 4T-1) is timed alone: ``k_steps`` dependent calls ended by a value
fetch (``utils.benchtime.time_chained``), wall / k_steps, the median of
``reps`` timed runs after one untimed run. Plain-PyTorch stages therefore include
their launch cost, which on the card is what they cost the tick.

Stages:
  full_tick      ``mpc_step_batched`` (K1 + K2), the cross-check
  reference      velocity-lookahead reference (``compute_reference``)
  lin_cond       plain rollout + linearize + condense (``build_qp_reference``)
  ruiz           plain ``_ruiz_equilibrate``, its default 10 passes
  factor_1round  ``torch.linalg.cholesky`` + ``cholesky_solve`` of
                 M = Ps + sigma I + rho Gs'Gs, one round's factorization
  admm_1round    Probe-3 (``admm_iterations``): one round of ``admm_iters``
                 iterations on the Ruiz-scaled QP at rho = ``admm_rho``
  resid_1round   plain residuals + the OSQP rho rule, one round
  round_full     Probe-1 (``admm_round_full``): factorization, iterations
                 and residuals of one round in one launch
  admm_all       Probe-2 (``admm_all_rounds``): ``admm_rounds`` rounds, one
                 launch, rho adapted in the kernel
  polish         A/B-2 (``polish_select``) on the zero solution
  condense_k     K1 (``build_qp``)
  ruiz_admm      A/B-1 (``ruiz_admm_all_rounds``) warm-started from its own
                 previous call, with the histograms of check blocks run
                 cold (the first call) and warm (the last)
  solver_total   K2 through ``solve_box_qp``, ``admm_rounds`` x ``admm_iters``

On CPU tensors every wrapper runs its plain version, so ``device="cpu"``
runs the same stages at a small size (times then say nothing of a card).

    python -m mpc_for_av_at_intersection_tpu_torch.bench_profile [out.json]

prints the report as one JSON object (and writes it to ``out.json``).
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from .core import smooth_yaw_numpy
from .models import bicycle_geometry
from .mpc import MPCConfig, init_controller_state
from .mpc.batch import mpc_step_batched
from .mpc.qp import QPSolution, _mtv, _mv, _ruiz_equilibrate, scale_qp
from .mpc.reference import compute_reference
from .ops.admm import polish_select, ruiz_admm_all_rounds, solve_box_qp
from .ops.admm_probes import admm_all_rounds, admm_iterations, admm_round_full
from .ops.condense_qp import build_qp, build_qp_reference
from .utils.benchtime import time_chained

N_COURSE = 512
DL = 0.083
# NVIDIA H100 SXM: float32 peak outside the tensor cores, HBM rate
H100_F32_FLOPS, H100_HBM_BPS = 67e12, 3.35e12


def course_inputs(B: int, rng: np.random.Generator):
    """Courses and states of ``bench_profile.py:75-95``: (course (B, N, 3),
    state (B, 4)) as float64 numpy."""
    turn = rng.normal(0.0, 0.01, size=(B, N_COURSE)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * DL, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(0, B, 64):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 40, size=B)
    state = np.stack([course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
                      rng.uniform(0.0, 8.0, B), course[np.arange(B), i0, 2]], axis=1)
    return course, state


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


class StageTimer:
    """Times stages as the profilers do and records ``<name>_ms`` in
    ``report``: ``k_steps`` dependent calls ``carry = step(carry)`` through
    ``utils.benchtime.time_chained`` (ended by a value fetch, whose own cost
    is subtracted), one untimed run, then the median of ``reps`` runs. The
    last run's final carry stays in ``carry``."""

    def __init__(self, report: dict, k_steps: int, reps: int):
        self.report, self.k_steps, self.reps = report, k_steps, reps
        self.carry = None

    def __call__(self, name: str, step, carry) -> float:
        time_chained(step, carry, self.k_steps)
        ts = []
        for _ in range(self.reps):
            dt, self.carry = time_chained(step, carry, self.k_steps)
            ts.append(dt)
        ms = statistics.median(ts) * 1e3
        self.report[name + "_ms"] = ms
        print(f"{name:22s} {ms:9.3f} ms", file=sys.stderr, flush=True)
        return ms


def profile_controller(batch: int = 4096, T: int = 20, k_steps: int = 8, reps: int = 5,
                       device=torch.device("cuda")) -> dict:
    """The per-stage report of the controller tick at ``batch`` scenarios
    and horizon ``T`` (stage times in ms; see the module docstring)."""
    device = torch.device(device)
    geom = bicycle_geometry()
    cfg = MPCConfig(T=T)
    B, n, m = batch, 2 * T, 4 * T - 1
    f32 = torch.float32
    K = k_steps
    course, state = course_inputs(B, np.random.default_rng(0))
    states = torch.tensor(state, dtype=f32, device=device)
    courses = torch.tensor(course, dtype=f32, device=device)
    cv = torch.zeros((B, N_COURSE), dtype=f32, device=device)
    valid = torch.full((B,), N_COURSE, dtype=torch.int32, device=device)
    dls = torch.full((B,), DL, dtype=f32, device=device)
    cs = init_controller_state(cfg, device=device, batch=B)
    eps = 1e-30

    report = {"device": device_name(device), "batch": B, "T": T, "n": n, "m": m,
              "k_steps": K, "reps": reps, "admm_rounds": cfg.admm_rounds,
              "admm_iters": cfg.admm_iters}
    timed = StageTimer(report, K, reps)

    # ---- full controller tick (cross-check) ----
    t_full = timed("full_tick", lambda c: mpc_step_batched(states, courses, cv, valid, dls, c,
                                                           cfg, geom.wheelbase).state, cs)
    # the share of rows the last timed tick solved (its carried have_prev)
    report["full_tick_solved_share"] = float(timed.carry.have_prev.float().mean())

    # ---- reference ----
    ov0 = torch.zeros((B, T + 1), dtype=f32, device=device)
    no_ov = torch.zeros((B,), dtype=torch.bool, device=device)
    t_ref = timed("reference",
                  lambda ti: compute_reference(states, courses, cv, valid, dls, ti, ov0, no_ov, T,
                                               cfg.dt, use_speed_channel=cfg.speed_ref).target_idx,
                  cs.target_idx)

    # ---- rollout + linearize + condense, plain ----
    zeros_T = torch.zeros((B, T), dtype=f32, device=device)
    xref0 = torch.zeros((B, cfg.nx, T + 1), dtype=f32, device=device)
    re0 = torch.zeros((B, T + 1), dtype=torch.bool, device=device)

    def lin_cond(u):
        q = build_qp_reference(states, u[0], u[1], xref0, re0, cfg, geom.wheelbase).q
        return u[0] + eps * q[:, 0:2 * T:2], u[1] + eps * q[:, 1:2 * T:2]

    timed("lin_cond", lin_cond, (zeros_T, zeros_T))
    cqp = build_qp_reference(states, zeros_T, zeros_T, xref0, re0, cfg, geom.wheelbase)
    P, q, G, lo, hi = cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi

    # ---- Ruiz equilibration, plain ----
    timed("ruiz", lambda q_: q_ + eps * _ruiz_equilibrate(P, q_, G)[0], q)

    # the Ruiz-scaled QP of the factor / ADMM stages
    Ps, qs, Gs, los, his = scale_qp(P, q, G, lo, hi, *_ruiz_equilibrate(P, q, G))
    rho = torch.full((B,), cfg.admm_rho, dtype=f32, device=device)
    eye = torch.eye(n, dtype=f32, device=device)
    sigma, alpha = cfg.admm_sigma, cfg.admm_alpha

    def factor(r):
        M = Ps + sigma * eye + r[:, None, None] * (Gs.transpose(1, 2) @ Gs)
        return torch.cholesky_solve(eye.expand(B, n, n), torch.linalg.cholesky(M))

    # ---- one round's factorization, plain (cuSOLVER / cuBLAS on the card) ----
    timed("factor_1round", lambda r: r + eps * factor(r)[:, 0, 0], rho)
    Minv = factor(rho).contiguous()

    x0 = torch.zeros((B, n), dtype=f32, device=device)
    z0 = torch.zeros((B, m), dtype=f32, device=device)
    y0 = torch.zeros((B, m), dtype=f32, device=device)

    # ---- Probe-3: one round of iterations ----
    t_admm1 = timed("admm_1round", lambda s: admm_iterations(Minv, Gs, qs, los, his, rho, *s,
                                                             cfg.admm_iters, sigma, alpha),
                    (x0, z0, y0))

    # ---- residuals + rho rule, plain ----
    def resid(r):
        Gx = _mv(Gs, x0)
        Px = _mv(Ps, x0)
        prim = (Gx - z0).abs().amax(1)
        dual = (Px + qs + _mtv(Gs, z0)).abs().amax(1)
        pr = prim / torch.clamp(torch.maximum(Gx.abs().amax(1), z0.abs().amax(1)), min=1e-6)
        dr = dual / torch.clamp(torch.maximum(Px.abs().amax(1), qs.abs().amax(1)), min=1e-6)
        return torch.clamp(r * torch.sqrt((pr + 1e-12) / (dr + 1e-12)), 1e-6, 1e6)

    timed("resid_1round", resid, rho)

    # ---- Probe-1: one whole round in one launch ----
    timed("round_full", lambda s: admm_round_full(Ps, Gs, qs, los, his, rho, *s, cfg.admm_iters,
                                                  sigma, alpha)[:3], (x0, z0, y0))

    # ---- Probe-2: every round in one launch, rho adapted in the kernel ----
    timed("admm_all", lambda s: admm_all_rounds(Ps, Gs, qs, los, his, rho, *s, cfg.admm_rounds,
                                                cfg.admm_iters, sigma, alpha)[:3], (x0, z0, y0))

    # ---- A/B-2: the polish on the zero solution ----
    zero_sol = QPSolution(x0, z0, torch.zeros((B,), dtype=torch.bool, device=device),
                          torch.zeros((B,), dtype=f32, device=device),
                          torch.zeros((B,), dtype=f32, device=device))
    t_polish = timed("polish", lambda x: x + eps * polish_select(P, q, G, lo, hi,
                                                                zero_sol._replace(x=x)).x, x0)

    # ---- K1 ----
    t_cond = timed("condense_k", lambda oa: oa + eps * build_qp(states, oa, zeros_T, xref0, re0,
                                                                cfg, geom.wheelbase).q[:, :1],
                   zeros_T)

    # ---- A/B-1 warm-started from its own previous call ----
    lq = build_qp(states, zeros_T, zeros_T, xref0, re0, cfg, geom.wheelbase)
    checks_n, check_iters, s_eps, s_band, s_cap, s_ratio = cfg.solver_schedule
    warm0 = (x0, y0, torch.full((B,), cfg.admm_rho, dtype=f32, device=device))

    checks = []

    def ruiz_admm_step(carry, record=False):
        q_in, warm = carry
        sol = ruiz_admm_all_rounds(lq.P, q_in, lq.G, lq.lo, lq.hi, rounds=checks_n,
                                   iters=check_iters, rho0=cfg.admm_rho, sigma=sigma, alpha=alpha,
                                   warm=warm, eps=s_eps, refactor_band=s_band, stall_cap=s_cap,
                                   stall_ratio=s_ratio)
        if record:
            checks.append(sol.checks)
        return q_in + eps * sol.x, (sol.x, sol.y, sol.rho)

    t_ruiz_admm = timed("ruiz_admm", ruiz_admm_step, (lq.q, warm0))
    carry = (lq.q, warm0)
    for _ in range(K):
        carry = ruiz_admm_step(carry, record=True)
    for tag, chk in (("cold", checks[0]), ("warm", checks[-1])):
        report[f"admm_checks_{tag}_hist"] = np.bincount(
            chk.cpu().numpy().astype(int), minlength=checks_n + 1).tolist()

    # ---- K2 through solve_box_qp, the fixed rounds x iters budget ----
    timed("solver_total", lambda q_: q_ + eps * solve_box_qp(
        P, q_, G, lo, hi, polish=cfg.polish, rounds=cfg.admm_rounds, iters=cfg.admm_iters,
        rho0=cfg.admm_rho, sigma=sigma, alpha=alpha).x, q)

    accounted = t_ref + t_cond + t_ruiz_admm + t_polish
    report["accounted_ms"] = accounted
    report["unaccounted_ms"] = t_full - accounted
    report["note"] = (
        "each stage timed alone: k_steps dependent calls ended by a value fetch "
        "(its own cost subtracted), wall / k_steps, median of reps; stages of plain "
        "PyTorch include their kernel launches, so stage sums need not equal "
        "full_tick_ms and unaccounted_ms may be negative")

    # ---- the ADMM iteration kernel (Probe-3) against the card's peak ----
    it_flops = 2 * (n * n + 2 * m * n) + 8 * (n + m)       # per scenario per iteration
    round_flops = B * cfg.admm_iters * it_flops
    # Probe-3's shared memory (M^-1, G, vectors, reduction scratch) and the
    # bytes it moves: M^-1, G, q, lo, hi, rho, x, z, y in, x, z, y out
    resident = 4 * ((n | 1) * (n + m) + 4 * n + 5 * m + 32)
    report["admm_kernel"] = {
        "flops_per_iter_per_scenario": it_flops,
        "round_gflops": round_flops / 1e9,
        "achieved_gflops_per_s": round_flops / (t_admm1 / 1e3) / 1e9,
        "resident_bytes_per_scenario": resident,
        "hbm_bytes_per_round": B * 4 * (n * n + m * n + 3 * n + 6 * m + 1),
        "note": ("one CTA per scenario, M^-1 and G in shared memory, three dependent "
                 "matvec phases an iteration; NVIDIA H100 SXM float32 peak outside the "
                 f"tensor cores {H100_F32_FLOPS / 1e12:.0f} TFLOP/s, HBM "
                 f"{H100_HBM_BPS / 1e12:.2f} TB/s"),
    }
    return report


def emit(report: dict, argv) -> int:
    """Print the report as one JSON object; write it to the first argument
    that is not an option, if any."""
    out = json.dumps(report, indent=2)
    print(out)
    paths = [a for a in argv if not a.startswith("--")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(out + "\n")
    return 0


def main(argv=None) -> int:
    return emit(profile_controller(), sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
