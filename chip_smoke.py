#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``mpc_for_av_at_intersection_tpu_torch/csrc``
and checks each against its plain PyTorch version on the card. Then it
drives the port's paths:

- the batched controller tick (``mpc_step_batched``, kernels K1 and K2)
  closed loop through the plant at the size of the repo's headline
  benchmark (B=4096 scenarios, horizon T=20, N=512-point courses), phases
  4-6;
- the course planner (kernel K3, serial A*) on the 12 standard junctions
  and on 1024 sampled junction geometries, phases 7-8, and the fleet:
  ``sample_intersection_fleet_batched`` planning on the card, then
  ``run_batch_episodes`` over 1024 scenarios x 32 ticks (K1 and K2 every
  tick), held against the CPU plain path, phase 9;
- the beam planner (``plan_courses_device(engine="beam")``, kernel K4
  once per iteration) on the same 1024 sampled geometries, phase 11, with
  K4 held to its plain version on three of its iterations' inputs, phase
  10;
- the sampled-geometry Monte-Carlo fleet: ``sample_intersection_fleet_geom``
  (1024 junctions, K3 on the card, the native C++ search for its misses
  and redraws), then 1024 scenarios x 128 ticks, held against the CPU
  plain path, phase 12;
- the controller's other configurations and solves: the two-launch twin
  of K2 (``solve_box_qp(fused=False)``: A/B-1 Ruiz + ADMM, then A/B-2
  polish) on the headline QPs, bit for bit against K2, phase 13; K1's jerk
  mode and K2 at the jerk variant's odd n, phase 14; the jerk tick
  (``MPCConfig.with_jerk()``, K1 jerk + K2) and the unpolished tick
  (``polish=False``, K1 + A/B-1) closed loop at the headline size, phases
  15-16; phase 9's fleet under the jerk controller, phase 17;
- the per-stage profile path: the three ADMM probes (Probe-1/2/3, kernels
  of ``ops/admm_probes.py``) against their plain versions on random
  box-QPs and on the headline QP, phase 18; the controller profiler
  (``bench_profile.profile_controller``, B=4096, T=20), whose ADMM stages run
  the probes, phase 19; the fleet tick profiler
  (``bench_profile_engine.profile_engine``, B=1024), phase 20;
- the single-scenario closed loop: the seven scenario drivers of ``api``
  through ``run_episode`` (``run_multi_ego_episode`` for the two-ego
  crossing) at B=1, K1 and K2 once a tick, the flagship also under the
  jerk and the unpolished controller, the flagship and the speed-reference
  driver replayed on the CPU plain path, phase 21;
- the multi-ego engine: the 8-ego two-lane junction for 300 ticks
  (``run_multi_ego_episode``, one K1 and one K2 launch a tick at B=8), then
  ``bench_multi_ego.py``'s sweep of S = 16 ... 1024 junctions through
  ``multi_ego_fleet_tick`` (up to 8,192 QPs a launch, the conflict scan
  one kernel launch), S=1024 with the scan as the kernel and as the plain
  torch scan, sliced and whole, bit for bit,
  and S = 2048 and 4096 (up to 32,768 QPs a launch), phase 22;
- checkpoint and resume: phase 9's fleet through ``utils.checkpoint.run_chunked``,
  broken off after 16 ticks and resumed from its file, bit-equal to the
  straight run, phase 23;
- the sweeps (``sweep.mpc_weight_sweep`` over w_perp, ``planner_weight_sweep``)
  and the live loop (``engine.run_episode_live``, 40 ticks, equal to
  ``run_episode``), phase 24;
- the CLI, each command in a subprocess of its own: ``run``, ``plan``,
  ``fleet --planner device`` (K3, then K1 and K2), ``sweep``, the
  multi-process fleet worker as one NCCL rank, and ``bench``, their launches
  counted, phase 25;
- horizons past one CTA's shared memory, where K2, A/B-1 and A/B-2 run a
  scenario on a thread-block cluster of 2-4 CTAs: the tick under
  ``MPCConfig(T=40, dt=0.1)`` at the headline width (canonical, jerk,
  unpolished; closed loop, every row re-run against the float64 tick), the
  T=40 QP's solves and the two-launch twin bit for bit K2, one T=48 tick at
  B=1024 (K2 on two CTAs), and the flagship driver at T=40 to the end of
  its episode, phase 26;
- the fleet at T=40, dt=0.1: ``sample_intersection_fleet_batched`` (K3)
  and ``run_batch_episodes`` over 1024 scenarios x 64 ticks (K1 at n = 80,
  K2 on clusters of two CTAs every tick), held against the plain path on
  the card and the CPU plain path, phase 27.

    python3 chip_smoke.py              # everything above
    python3 chip_smoke.py --digests    # only the digests of K1's to A/B-2's and K3's outputs
    python3 chip_smoke.py --solve-times  # only the ADMM-family kernels' times and clock split (T=20, T=13, T=40)
    python3 chip_smoke.py --astar-times  # only K3's time, occupancy and memory at phase 8's inputs
    python3 chip_smoke.py --k1k4-times   # only K1's and K4's times, occupancy and section split
    python3 chip_smoke.py --scan-times   # only the scan kernel's and the plain scan's times
    python3 chip_smoke.py --long-horizon  # only phase 26 (after the build)
    python3 chip_smoke.py --fleets     # only phases 22 and 27 (after the build)
    python3 chip_smoke.py --long-horizon-numerics  # where K2 and the plain solver part, T=20-48
    python3 chip_smoke.py --tail-sample  # K2's T=40 tail rows against the float64 optimum

Prints one line per phase with its seconds, then a JSON line with each
kernel's launches, error, times and bound, the card's name and power limit
as nvidia-smi reports them, and finally ``{"ok": true, "device": {...}}``.
Exits non-zero, without that last line, when no CUDA device is present or
any phase fails.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
B, T, N = 4096, 20, 512          # bench.py:18-20
DL = 0.083                       # course tick [m]
N_WARM = 20                      # warm ticks after the cold one
CPU_ROWS = 512                   # rows re-run on the CPU plain path
K1_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/condense_qp.cu"
K2_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/admm.cu"
K3_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/astar.cu"
K4_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/collision.cu"
K1_REPLACES = "mpc_for_av_at_intersection_tpu/ops/condense_pallas.py:35"
K2_REPLACES = "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:835"
K3_REPLACES = "mpc_for_av_at_intersection_tpu/ops/astar_pallas.py:60"
K4_REPLACES = "mpc_for_av_at_intersection_tpu/ops/collision_pallas.py:109"
AB1_REPLACES = "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:509"
AB2_REPLACES = "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:1006"
PROBE_REPLACES = {"admm_iterations": "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:65",
                  "admm_round_full": "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:96",
                  "admm_all_rounds": "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:316"}
PROBE_B, PROBE_N, PROBE_M = 4096, 6, 9   # random box-QPs of tests/test_batched_solver.py
ENGINE_B = 1024                          # bench_profile_engine.py:30
FLEET_B, FLEET_T = 1024, 32      # bench.py:147 (fleet_scenario_ticks_per_s)
GEOM_B, GEOM_PLAIN_ROWS = 1024, 16
FLEET_CPU_ROWS = 64
BEAM_PLAIN_ROWS = 64             # rows the beam and K4 are compared on
GEOM_FLEET_B, GEOM_FLEET_T = 1024, 128   # bench_montecarlo.py:34 (N_STEPS)
ME_COMBOS = ((1, 2, 1), (1, 3, 2), (2, 2, 1), (2, 3, 2),   # tests/test_prius_and_fleet.py:65-70
             (3, 2, 1), (3, 3, 2), (4, 2, 1), (4, 3, 2))   # (start_pos, turn, lane)
ME_STEPS = 300                   # tests/test_prius_and_fleet.py::test_eight_ego_intersection
ME_SWEEP = (16, 32, 64, 128, 256, 512, 1024)   # bench_multi_ego.py:140-175
ME_LARGE = (2048, 4096)          # past the sweep: 16,384 and 32,768 egos
ME_CHAIN, ME_REPS = 8, 3         # chained ticks a measurement, measurements a size
REALTIME_MS = 200.0              # bench_multi_ego.py: the real-time budget of one tick
CKPT_CHUNK, CKPT_BREAK = 8, 16   # phase 23: chunk of run_chunked, ticks before the break
SWEEP_VALUES, SWEEP_STEPS = (1.0, 5.0, 20.0), 64   # phase 24 (cli.py's sweep values)
LIVE_STEPS = 40                  # phase 24: ticks of the live loop
CLI_TIMEOUT = 300                # seconds a CLI subprocess of phase 25 may take
# H100 SXM peaks: HBM bytes/s, float32 FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_inputs(seed, horizon=T):
    """Course/state generator of bench.py:57-75 (previous controls over
    ``horizon`` steps)."""
    from mpc_for_av_at_intersection_tpu_torch.core import smooth_yaw_numpy

    rng = np.random.default_rng(seed)
    turn = rng.normal(0.0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * DL, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(0, B, max(B // 64, 1)):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 40, size=B)
    state = np.stack([
        course[np.arange(B), i0, 0] + rng.normal(0, 0.2, B),
        course[np.arange(B), i0, 1] + rng.normal(0, 0.2, B),
        rng.uniform(0.0, 8.0, B),
        course[np.arange(B), i0, 2] + rng.normal(0, 0.1, B),
    ], axis=1)
    oa = rng.normal(0.0, 1.0, size=(B, horizon))     # previous controls for K1's rollout
    od = rng.normal(0.0, 0.2, size=(B, horizon))
    return state, course, oa, od


def headline_inputs(dev, horizon=T):
    """The headline tick's inputs on the card: ((states, courses, speeds,
    valid lengths, dls), previous controls oa and od, and the cold
    reference of ``compute_reference``), at horizon T unless ``horizon``
    is given."""
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference

    f32 = torch.float32
    state_np, course_np, oa_np, od_np = bench_inputs(SEED, horizon)
    states0 = torch.tensor(state_np, dtype=f32, device=dev)
    courses = torch.tensor(course_np, dtype=f32, device=dev)
    speeds = torch.zeros((B, N), dtype=f32, device=dev)
    valid = torch.full((B,), N, dtype=torch.int32, device=dev)
    dls = torch.full((B,), DL, dtype=f32, device=dev)
    oa = torch.tensor(oa_np, dtype=f32, device=dev)
    od = torch.tensor(od_np, dtype=f32, device=dev)
    cfg = MPCConfig(T=horizon)
    cs0 = init_controller_state(cfg, device=dev, batch=B)
    ref = compute_reference(states0, courses, speeds, valid, dls, cs0.target_idx, cs0.ov,
                            cs0.have_ov, horizon, cfg.dt)
    return (states0, courses, speeds, valid, dls), oa, od, ref


def k1_inputs(inputs, oa, od, ref, cfg=None):
    """K1's arguments for the headline tick (canonical ``MPCConfig(T=T)``
    unless ``cfg`` is given)."""
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig

    return (inputs[0], oa, od, ref.xref, ref.reaches_end, cfg or MPCConfig(T=T),
            bicycle_geometry().wheelbase)


# sha256 (first 16 hex digits) of the inputs and outputs of
# ``kernel_digests`` (``python3 chip_smoke.py --digests`` on an NVIDIA H100
# 80GB HBM3, 700.00 W): the inputs and K1 as the kernels gave them before
# K2's phases were split into the device functions that A/B-1 and A/B-2
# share and K1 gained its jerk mode; A/B-1 as the package of the version
# before the polish's redesign gave it (its K2 still gave the split's
# k2_cold 85655ce02d4b265b and k2_warm ee7b151d3df20fd1); K2 since its
# polish factors only the active rows of the Schur system (the Schur solves
# sum in another order, so x and y moved at rounding level); A/B-2 (on the
# plain solver's output) as the polish of the active rows gives it.
PINNED_DIGESTS = {"inputs": "086da3b42976608f", "k1": "aa0030424c624fa0",
                  "k2_cold": "a85d982c2990f73d", "k2_warm": "4970233ab2fbad32",
                  "ab1_cold": "0564da94aaddc9e9", "ab1_warm": "d8949bcc91f64b15",
                  "ab2": "5b7a37b35b7272b9",
                  # K3's result (``k3_digests``) on phase 7's and phase 8's
                  # inputs, as the package of the version before the min
                  # tree (the heap) gave them
                  "k3_junctions": "0ea2ac4fbf6c8fc3", "k3_geom": "8423362e8dd0242c",
                  # K2 (cold, and warm from its own cold output) and A/B-1
                  # (cold) on clusters of two CTAs, on the T=40 headline QP
                  # (``long_digests``), as this version gives them
                  "k2_t40_cold": "5ace36a67913b6ff", "k2_t40_warm": "6e8c2d162e16b84d",
                  "ab1_t40": "9a0bd67f34d69690"}
K3_PINS = ("k3_junctions", "k3_geom")
# the fields of a solve's result that its pins hash: every field but the
# factorization count, which the solvers gained after the pins were taken
PINNED_SOLUTION = ("x", "y", "polished", "prim_res", "dual_res", "rho", "checks")


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy())
    return h.hexdigest()[:16]


def _solution_digest(sol):
    return _digest([getattr(sol, f) for f in PINNED_SOLUTION])


def pinned(*names):
    """The pins of ``names``, or every pin but K3's."""
    return {k: v for k, v in PINNED_DIGESTS.items()
            if (k in names if names else k not in K3_PINS + LONG_PINS)}


def kernel_digests(k1_args, kw):
    """Digests of canonical K1's outputs on the headline tick's inputs and
    of K2's and A/B-1's on that QP, cold and warm-started from the same
    kernel's cold solution, and of A/B-2's on an ADMM solution no kernel
    made (the plain solver's cold x, y and primal residual on that QP): the
    kernels' results bit for bit, comparable across versions of the port
    (only entry points every version since the two-launch split has are
    called). A/B-2's digest is taken twice from a fresh plain solve each
    time; two that differ are reported as ``ab2_repeat``."""
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import ruiz_admm_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    qp_k = build_qp(*k1_args)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    out = {"inputs": _digest(k1_args[:5]), "k1": _digest(qp_k)}
    for name, solve in (("k2", solve_box_qp_fused), ("ab1", ruiz_admm_all_rounds)):
        cold = solve(*qp, **kw)
        warm = solve(*qp, warm=(cold.x, cold.y, cold.rho), **kw)
        out[f"{name}_cold"], out[f"{name}_warm"] = _solution_digest(cold), _solution_digest(warm)
    ab2 = [_solution_digest(polish_select(*qp, ruiz_admm_batched(*qp, **kw))) for _ in range(2)]
    out["ab2"] = ab2[0]
    if ab2[1] != ab2[0]:
        out["ab2_repeat"] = ab2[1]
    return out


def cuda_ms(fn, reps):
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def solved_mask(sol):
    """The controller's ``solved`` gate (``mpc/batch.py``)."""
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import SOLVED_PRIM_MAX

    return sol.x.isfinite().all(1) & sol.prim_res.isfinite() & (sol.prim_res < SOLVED_PRIM_MAX)


def quantiles(v, ps=(0.5, 0.9, 0.99)):
    v = v.double().cpu()
    return [float(v.quantile(p)) if v.numel() else 0.0 for p in ps]


def active_rows(sol):
    """p50/p90/p99/max of a, the nonzero multipliers of the rows whose
    polish was accepted: the active rows the polish factored."""
    a = (sol.y != 0).sum(1)[sol.polished]
    return "/".join(f"{v:g}" for v in quantiles(a, (0.5, 0.9, 0.99, 1.0)))


def true_solution(qp):
    """Float64 solve of the same QPs with the plain solver run to a tight
    tolerance, and the rows whose KKT residuals certify it as optimal."""
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import kkt_residuals, solve_box_qp_batched

    a64 = tuple(a.double() for a in qp)
    sol = solve_box_qp_batched(*a64, rounds=40, iters=50, eps=1e-9, refactor_band=5.0,
                               ruiz_iters=10)
    stat, prim, comp = kkt_residuals(*a64, sol.x, sol.y)
    scale = a64[0].abs().amax((1, 2)).clamp(min=1.0) * sol.x.abs().amax(1).clamp(min=1.0)
    cert = sol.polished & (stat <= 1e-6 * scale) & (prim <= 1e-7) & (comp <= 1e-6 * scale)
    return sol.x, cert


def compare_solutions(kern, plain, x_true, cert, tag, min_certified=0.95, min_solved=0.98):
    """The kernel must solve the QPs at least as well as the plain version.

    At B=4096, T=20 the condensed Hessian's condition number reaches ~1e7,
    so in float32 x is fixed only up to directions of near-zero curvature,
    and two correct float32 solvers (the plain version on the CPU and on
    the card among them) differ by far more than the 5e-4 / 2e-2 bars of
    tests/test_batched_solver.py:47-57. Both are therefore held to the
    float64 optimum on the rows it certifies: the kernel's error quantiles
    may not exceed 1.5x the plain version's (+1e-5), nor may it have more
    rows off by > 2e-2 (+1% of rows). The polished count must reach plain's
    minus rows/32, and the solved share ``min_solved`` (98%). The float64
    optimum must be certified on ``min_certified`` of the rows.
    """
    rows = kern.x.shape[0]
    both = kern.polished & plain.polished
    d = (kern.x - plain.x).abs().amax(1)
    err_both = float(d[both].max()) if bool(both.any()) else 0.0
    ek = (kern.x.double() - x_true).abs().amax(1)[cert]
    ep = (plain.x.double() - x_true).abs().amax(1)[cert]
    qk, qp_ = quantiles(ek), quantiles(ep)
    tail_k, tail_p = int((ek > 2e-2).sum()), int((ep > 2e-2).sum())
    n_kern, n_plain = int(kern.polished.sum()), int(plain.polished.sum())
    share = float(solved_mask(kern).float().mean())
    print(f"{tag}: error vs float64 optimum ({int(cert.sum())} certified rows) p50/p90/p99 "
          f"kernel {qk[0]:.3g}/{qk[1]:.3g}/{qk[2]:.3g}, plain {qp_[0]:.3g}/{qp_[1]:.3g}/"
          f"{qp_[2]:.3g}; rows > 2e-2 kernel {tail_k} plain {tail_p}; polished kernel {n_kern} "
          f"plain {n_plain}; solved {share:.4f}; kernel vs plain max|dx| where both polished "
          f"{err_both:.3g}; checks mean kernel {float(kern.checks.mean()):.3f} "
          f"plain {float(plain.checks.mean()):.3f}")
    check(int(cert.sum()) >= min_certified * rows,
          f"{tag}: float64 optimum certified on {int(cert.sum())} rows")
    for p, a, b in zip((50, 90, 99), qk, qp_):
        check(a <= 1.5 * b + 1e-5, f"{tag}: p{p} error {a} > 1.5 x plain {b}")
    check(tail_k <= tail_p + rows // 100, f"{tag}: {tail_k} rows off by > 2e-2, plain {tail_p}")
    check(n_kern >= n_plain - rows // 32, f"{tag}: polished {n_kern} < plain {n_plain} - B/32")
    check(share >= min_solved, f"{tag}: solved share {share} < {min_solved}")
    return err_both


def controls(out, rows=slice(None)):
    """(rows, 2) float64 accel/steer on the CPU."""
    return torch.stack([out.accel[rows].cpu(), out.steer[rows].cpu()], dim=1).double()


def k1_bound(B, T, jerk=False):
    """(ms, "bytes"|"operations") for K1 at this shape: its inputs read once,
    its outputs written once (n = 2T, nx = 4; the jerk mode n = 2T+1,
    nx = 5); flops of the rollout, the column recurrences of F and the P/q
    sums."""
    n, m, nx = 2 * T + int(jerk), 4 * T - 1, 4 + int(jerk)
    nbytes = B * (4 * (4 + 2 * T + 4 * (T + 1)) + (T + 1)
                  + 4 * (n * n + n + m * n + 2 * m + nx * T * n + nx * T))
    flops = B * (n * T * (32 + 4 * int(jerk)) + n * n // 2 * T * 20 + n * T * 20 + 200 * T)
    return _bound(nbytes, flops)


def solve_bound(qp, sol, iters, ruiz_iters, warm, admm=True, polish=True):
    """The bound of a solve kernel from this solve (``sol`` its result):
    K2 runs both phases, A/B-1 the ADMM, A/B-2 the polish. Bytes: inputs
    read once (A/B-2 also the ADMM's x, y, prim), outputs written once.
    Operations at the least each row needed. The ADMM: Ruiz (3 passes over P
    and G an iteration), G'G (m n^2), one Cholesky of the ADMM matrix (n^3/3;
    every row factors at least once), the iterations it ran (checks x iters
    at 2n^2 + 4mn + 10m, plus 2n^2 + 4mn of residuals per check). The
    polish: one attempt, a Cholesky of P (n^3/3), G P^-1 G' (m n^2), the
    Schur block of its a active rows (a^2 n + a^3/3) and two KKT solves
    (4n^2 + 4mn + 2a^2 each); a is the row's nonzero multipliers where the
    polish was accepted, else 0. Further refactorizations and second
    attempts are not counted."""
    B, m, n = qp[2].shape
    handed = n + m + 1 if (warm or not admm) else 0
    nbytes = B * 4 * (n * n + n + m * n + 2 * m + handed + n + m + (4 if admm else 2))
    per_row = torch.zeros((B,), dtype=torch.float64, device=sol.x.device)
    if admm:
        per_row += (3 * ruiz_iters * (n * n + m * n) + m * n * n + n ** 3 / 3
                    + sol.checks.double() * (iters * (2 * n * n + 4 * m * n + 10 * m)
                                             + 2 * n * n + 4 * m * n))
    if polish:
        a = torch.where(sol.polished, (sol.y != 0).sum(1), 0).double()
        per_row += (n ** 3 / 3 + m * n * n + a * a * n + a ** 3 / 3
                    + 2 * (4 * n * n + 4 * m * n + 2 * a * a))
    return _bound(nbytes, per_row.sum().item())


def k3_bound(x, res):
    """K3's bound on this run's data: inputs read once, the parent/prim grid
    and result row written once. Operations: 4 per half-plane row the
    collision test evaluated (the kernel's own count, ``rows_tested``, which
    stops at a point's first positive row and first obstacle hit), 8 per
    collision point placed and about 60 per candidate, per expansion."""
    B, N = x.params.shape[0], x.N
    P = x.iconsts[5]
    n_pts = int(x.cc_mask.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (x.hp, x.hpn, x.ov, x.params)) + B * (4 * N + 28)
    flops = (4 * res.rows_tested.double().sum()
             + res.n_expansions.double().sum() * (8 * n_pts + 60 * P)).item()
    return _bound(nbytes, flops)


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The ADMM-family kernels of csrc/admm.cu, numbered as its
# admm_blocks_per_sm numbers them, with their names in the ptxas log.
ADMM_KERNELS = (("K2", "solve_polish_kernel"), ("A/B-1", "ruiz_admm_kernel"),
                ("A/B-2", "polish_select_kernel"), ("Probe-3", "admm_iterations_kernel"),
                ("Probe-1/2", "admm_all_rounds_kernel"))


def admm_bucket(n, m):
    """The mangled template arguments of the horizon bucket that
    ``csrc/admm.cu`` instantiates its ADMM kernels with at (n, m)
    (``in_t13``: BucketT13 for n, m within it, else BucketT20); None for a
    source without buckets."""
    import re

    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    found = dict(re.findall(r"using (BucketT\d+) = (Bucket<\d+, \d+, \d+>);",
                            (_build.CSRC_DIR / "admm.cu").read_text()))
    if not found:
        return None
    args = [re.findall(r"\d+", found[k]) for k in ("BucketT13", "BucketT20")]
    pick = args[0] if n <= int(args[0][0]) and m <= int(args[0][1]) else args[1]
    return "BucketIL" + "".join(f"i{a}EL" for a in pick)[:-1] + "E"


def admm_cluster_bucket(n, m):
    """The mangled template arguments of the cluster bucket that
    ``csrc/admm.cu`` instantiates its cluster kernels with at (n, m)
    (``in_c40``: BucketC40 for n, m within it, else BucketC60); None for a
    source without cluster buckets."""
    import re

    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    found = dict(re.findall(r"using (BucketC\d+) = (Bucket<\d+, \d+, \d+>);",
                            (_build.CSRC_DIR / "admm.cu").read_text()))
    if not found:
        return None
    args = [re.findall(r"\d+", found[k]) for k in ("BucketC40", "BucketC60")]
    pick = args[0] if n <= int(args[0][0]) and m <= int(args[0][1]) else args[1]
    return "BucketIL" + "".join(f"i{a}EL" for a in pick)[:-1] + "E"


def admm_kernel_report(n, m, names=None):
    """{kernel: "C CTAs/SM, R registers, F B stack, S B spilled"} for the
    ADMM-family kernels (all, or those in ``names``) at (n, m): the CTAs
    that fit an SM as the CUDA runtime counts them from registers and
    shared memory, and the registers, stack frame and spill stores + loads
    ptxas reported at the build for the instantiation of (n, m)'s horizon
    bucket (``admm_bucket``)."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    lib = _build.load()
    usage = ptxas_usage()
    bucket = admm_bucket(n, m)
    out = {}
    for i, (label, kernel) in enumerate(ADMM_KERNELS):
        if names is not None and label not in names:
            continue
        hits = [k for k in usage if kernel in k]
        u = usage[next((k for k in hits if bucket and bucket in k), hits[0])] if hits else {}
        out[label] = (f"{lib.admm_blocks_per_sm(i, n, m)} CTAs/SM, {u.get('regs')} registers, "
                      f"{u.get('stack')} B stack, {u.get('spill')} B spilled")
    return out


def admm_bucket_report(names=None):
    """``admm_kernel_report`` at each horizon bucket's own horizon: T=13
    (n = 26, m = 51) and T=20 (n = 40, m = 79)."""
    return {f"T={t}": admm_kernel_report(2 * t, 4 * t - 1, names) for t in (13, 20)}


_LAP = [time.perf_counter()]


def lap(name):
    """Print the seconds since the previous phase ended."""
    now = time.perf_counter()
    print(f"[phase {name}: {now - _LAP[0]:.1f} s]", flush=True)
    _LAP[0] = now


def k3_inputs(scenarios, dev, cfg):
    """The planner's K3 inputs for these scenarios (lattice/wavefront.py)."""
    from mpc_for_av_at_intersection_tpu_torch.lattice.primitives import primitive_table
    from mpc_for_av_at_intersection_tpu_torch.lattice.search import SearchWeights
    from mpc_for_av_at_intersection_tpu_torch.lattice.wavefront import prepare_primitives
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.worlds.scenario import (
        compile_scenario,
        stack_scenario_arrays,
    )

    geom = bicycle_geometry()
    arrs = stack_scenario_arrays([compile_scenario(sc, margin=geom.radius) for sc in scenarios])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    prims = prepare_primitives(primitive_table(geom), geom, np.float32)
    args = (t(arrs.halfplanes), t(arrs.obstacle_valid, torch.bool), t(arrs.start),
            t(arrs.goal_point), t(arrs.goal_area_corners), t(arrs.goal_theta_tol), prims, cfg,
            SearchWeights.modified())
    return args, prims


K3_JUNCTION_EXP, K3_GEOM_EXP = 8192, 20000   # expansion budgets of phases 7 and 8


def k3_junction_inputs(dev):
    """Phase 7's K3 inputs: the 12 standard junctions on one 40-bin grid."""
    from mpc_for_av_at_intersection_tpu_torch.lattice.wavefront import WavefrontConfig

    junctions = standard_junctions()
    cfg = WavefrontConfig.for_scenarios(junctions, ntheta=40)
    return (junctions, cfg) + k3_inputs(junctions, dev, cfg)


def k3_geom_inputs(dev):
    """Phase 8's K3 inputs: GEOM_B sampled junction geometries (api.py:536-575)
    on the grid the planner picks for them."""
    from mpc_for_av_at_intersection_tpu_torch.lattice.wavefront import grid_for

    scen = sampled_junctions(GEOM_B)
    _, cfg = grid_for(scen)
    return (scen, cfg) + k3_inputs(scen, dev, cfg)


def k3_digests(dev):
    """Digests of K3's whole result (found, cost, goal cell, expansions, oob,
    the parent and prim grids, rows_tested) on phase 7's and phase 8's
    inputs: the kernel's output bit for bit, comparable across versions."""
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch

    out = {}
    for name, inputs, budget in (("k3_junctions", k3_junction_inputs, K3_JUNCTION_EXP),
                                 ("k3_geom", k3_geom_inputs, K3_GEOM_EXP)):
        out[name] = _digest(astar_search_batch(*inputs(dev)[2], max_expansions=budget))
    return out


def ptxas_usage():
    """{kernel's mangled name: {"regs", "stack", "spill"}} from the ptxas log
    of the kernel library's build."""
    import re

    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    _build.load()
    usage, func = {}, None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and (hit := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage.setdefault(func, {}).update(stack=int(hit[1]), spill=int(hit[2]) + int(hit[3]))
        elif func and (hit := re.search(r"Used (\d+) registers", line)):
            usage.setdefault(func, {})["regs"] = int(hit[1])
    return usage


def k3_kernel_report(n_cells):
    """K3's "C CTAs/SM, R registers, F B stack, S B spilled" for a grid of
    ``n_cells``: the CTAs that fit an SM as the CUDA runtime counts them from
    registers and shared memory (None where the library cannot count them),
    and what ptxas reported at the build."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, astar

    per_sm = getattr(_build.load(), "k3_blocks_per_sm", None)
    ctas = per_sm(-(-n_cells // astar.level1_block(n_cells))) if per_sm else None
    u = next((v for k, v in ptxas_usage().items() if "astar_kernel" in k), {})
    return (f"{ctas} CTAs/SM, {u.get('regs')} registers, {u.get('stack')} B stack, "
            f"{u.get('spill')} B spilled")


def _usage(marker, template=None):
    """ptxas's {"regs", "stack", "spill"} of the first kernel whose mangled
    name holds ``marker`` and, where one has it, the template argument
    ``template`` (a kernel of an earlier version may have none)."""
    usage = ptxas_usage()
    hits = [k for k in usage if marker in k]
    return usage[next((k for k in hits if template and template in k), hits[0])] if hits else {}


def k1_kernel_report(horizon, jerk=False):
    """K1's "C CTAs/SM, R registers, F B stack, S B spilled" at this
    horizon: the CTAs that fit an SM at the wrapper's shared memory as the
    CUDA runtime counts them (None where the library has no occupancy
    entry), and what ptxas reported at the build."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, condense_qp

    per_sm = getattr(_build.load(), "k1_blocks_per_sm", None)
    launch = getattr(condense_qp, "k1_launch", None)
    ctas = per_sm(int(jerk), launch(horizon, jerk).smem_bytes) if per_sm and launch else None
    u = _usage("build_qp_kernel", f"ILb{int(jerk)}E")
    return (f"{ctas} CTAs/SM, {u.get('regs')} registers, {u.get('stack')} B stack, "
            f"{u.get('spill')} B spilled")


def k4_kernel_report(n_points):
    """K4's "C CTAs/SM, R registers, F B stack, S B spilled" for P*C =
    ``n_points`` collision points (the kernel instantiated at that many
    points a lane), as ``k1_kernel_report``."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, collision

    per_sm = getattr(_build.load(), "k4_blocks_per_sm", None)
    lanes = getattr(collision, "points_per_lane", None)
    k = lanes(n_points) if lanes else None
    ctas = per_sm(k) if per_sm and k else None
    u = _usage("k4_kernel", f"ILi{k}E")
    return (f"{ctas} CTAs/SM, {u.get('regs')} registers, {u.get('stack')} B stack, "
            f"{u.get('spill')} B spilled")


def replay(res, args, prims, cfg):
    from mpc_for_av_at_intersection_tpu_torch.lattice.wavefront import _backtrack_replay_batch

    points = torch.as_tensor(prims.points, device=res.found.device)
    return _backtrack_replay_batch(res.found, res.goal_cell, res.parent, res.prim, args[2],
                                   points, cfg.max_edges)


def k3_check(tag, kern, plain, args, prims, cfg, rows, cost_rtol, min_agree):
    """Kernel vs plain on the first ``rows`` rows: found identical, cost
    within ``cost_rtol`` relative on at least ``min_agree`` of the rows both
    found, trajectories of equal length within 1e-3 m. Returns max |dcost|."""
    kf, pf = kern.found[:rows].cpu(), plain.found.cpu()
    bad_found = torch.nonzero(kf != pf).flatten().tolist()
    both = (kf & pf).nonzero().flatten()
    kc, pc = kern.cost[:rows].cpu().double(), plain.cost.cpu().double()
    rel = ((kc - pc).abs() / pc.abs().clamp(min=1e-9))[both]
    off = both[rel > cost_rtol].tolist()
    for i in bad_found + off:
        print(f"K3 {tag} mismatch row {i}: found {bool(kf[i])}/{bool(pf[i])} cost "
              f"{float(kc[i]):.6f}/{float(pc[i]):.6f} expansions "
              f"{int(kern.n_expansions[i])}/{int(plain.n_expansions[i])}")
    ktr, kn, _, _ = replay(kern, args, prims, cfg)
    sub = tuple(a[:rows] if isinstance(a, torch.Tensor) else a for a in args)
    ptr, pn, _, _ = replay(plain, sub, prims, cfg)
    same = [i for i in both.tolist() if i not in off]
    n_eq = all(int(kn[i]) == int(pn[i]) for i in same)
    traj_err = max([float((ktr[i, :int(kn[i])] - ptr[i, :int(pn[i])]).abs().max())
                    for i in same if int(kn[i]) == int(pn[i]) and int(kn[i]) > 0] or [0.0])
    # the work count behind k3_bound: equal wherever the two searches agree
    ke, pe = kern.n_expansions[:rows].cpu(), plain.n_expansions.cpu()
    same_search = [i for i in range(rows) if i not in bad_found and i not in off
                   and int(ke[i]) == int(pe[i])
                   and int(kern.oob[i]) == int(plain.oob[i])]
    kt, pt = kern.rows_tested[:rows].cpu(), plain.rows_tested.cpu()
    bad_work = [i for i in same_search if int(kt[i]) != int(pt[i])]
    check(not bad_found, f"K3 {tag}: found differs on rows {bad_found}")
    check(len(both) - len(off) >= min_agree,
          f"K3 {tag}: cost agrees on {len(both) - len(off)} rows, need {min_agree}")
    check(n_eq, f"K3 {tag}: trajectory lengths differ")
    check(traj_err <= 1e-3, f"K3 {tag}: trajectories differ by {traj_err} m")
    check(not bad_work, f"K3 {tag}: rows_tested differs on rows {bad_work}")
    print(f"K3 {tag}: {rows} rows, found {int(kf.sum())}/{int(pf.sum())}, cost max rel err "
          f"{float(rel.max()) if len(rel) else 0.0:.3g} ({len(off)} rows > {cost_rtol}), "
          f"trajectory max err {traj_err:.3g} m; rows_tested equal on all {len(same_search)} "
          f"rows whose searches agree")
    return float((kc - pc).abs()[both].max()) if len(both) else 0.0


def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def long_horizon_kernels(long, long_fleet=None):
    """The ``kernels`` line's entries of phase 26's cluster instantiations:
    each kernel's launches from its main path there (the canonical, jerk
    and unpolished T=40 tick loops, the T=40 two-launch solve, the T=48
    tick), the flagship episode's and phase 27's fleet's beside them."""
    ep = long["episode_launches"]["solve_box_qp_fused_cluster"]
    fleet = {} if long_fleet is None else {
        "launches_long_fleet_path": long_fleet["launches"]["solve_box_qp_fused_cluster"]}

    def entry(name, replaces, launches, err, ms, plain_ms, bound, cluster, **more):
        return {"name": name, "route": "cuda", "source": K2_SOURCE, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                "cluster_ctas": cluster, **more}

    t, b = long["times"], long["bounds"]
    return [
        entry("solve_box_qp_fused (cluster, T=40)", K2_REPLACES,
              long["tick"]["launches"]["solve_box_qp_fused_cluster"], long["k2_err"],
              t["K2 warm"], t["K2 warm plain"], b["K2 warm"], long["cluster"]["T=40"],
              launches_single_scenario_path=ep, cold_ms=t["K2 cold"],
              cold_plain_ms=t["K2 cold plain"], **fleet),
        entry("solve_box_qp_fused (cluster, jerk T=40)", K2_REPLACES,
              long["jerk_tick"]["launches"]["solve_box_qp_fused_cluster"], long["jerk"]["err"],
              long["jerk"]["ms"], long["jerk"]["plain_ms"], long["jerk"]["bound"],
              long["cluster"]["jerk T=40"]),
        entry("solve_box_qp_fused (cluster, T=48)", K2_REPLACES,
              long["t48"]["launches"]["solve_box_qp_fused_cluster"], long["t48"]["err"],
              long["t48"]["ms"], long["t48"]["plain_ms"], long["t48"]["bound"],
              long["cluster"]["T=48"]),
        entry("ruiz_admm_all_rounds (cluster, T=40)", AB1_REPLACES,
              long["unpolished_tick"]["launches"]["ruiz_admm_all_rounds_cluster"],
              long["ab1_err"], t["A/B-1 warm"], t["A/B-1 warm plain"], b["A/B-1 warm"], 2,
              launches_two_launch_path=long["twin_launches"]["ruiz_admm_all_rounds_cluster"]),
        entry("polish_select (cluster, T=40)", AB2_REPLACES,
              long["twin_launches"]["polish_select_cluster"], long["ab2_err"], t["A/B-2"],
              t["A/B-2 plain"], b["A/B-2"], 2),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2

    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops import _build
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

    # full float32 in every matmul of the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi_line = nvidia_smi_line()
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi_line}")
    lap("1 device")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s -> {lib_path.name}; ptxas: {' | '.join(ptxas)}")
    lap("2 build")

    # ---- 3. inputs ----
    inputs, oa, od, ref = headline_inputs(dev)
    states0 = inputs[0]
    cfg = MPCConfig(T=T)
    k1_args = k1_inputs(inputs, oa, od, ref)
    print(f"inputs: seed {SEED}, B={B}, T={T}, N={N}")
    lap("3 inputs")

    # ---- 4. K1 vs plain ----
    qp_k = build_qp(*k1_args)
    qp_p = build_qp_reference(*k1_args)
    torch.cuda.synchronize()
    k1_err, k1_rel = 0.0, {}
    for name in qp_p._fields:
        a, b = getattr(qp_p, name), getattr(qp_k, name)
        err = float((a - b).abs().max())
        scale = max(1.0, float(a.abs().max()))
        k1_err = max(k1_err, err)
        k1_rel[name] = err / scale
        check(err <= 1e-5 * scale, f"K1 field {name}: error {err} > 1e-5 * {scale}")
    k1_ms = cuda_ms(lambda: build_qp(*k1_args), 20)
    k1_plain_ms = cuda_ms(lambda: build_qp_reference(*k1_args), 5)
    print("K1 vs plain, max|err|/max(1,|ref|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in k1_rel.items())
          + f" (bar 1e-5); kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")
    k1_bound_ms, k1_bound_by = k1_bound(B, T)
    print(f"K1 kernel: {k1_kernel_report(T)}")
    lap("4 K1")

    # ---- 5. K2 vs plain, cold then warm, both held to the float64 optimum ----
    kw = solver_kw(cfg)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    x_true, cert = true_solution(qp)
    cold_k = solve_box_qp_fused(*qp, **kw)
    cold_p = solve_box_qp_batched(*qp, **kw)
    k2_err = compare_solutions(cold_k, cold_p, x_true, cert, "K2 cold")
    warm = (cold_p.x, cold_p.y, cold_p.rho)
    warm_k = solve_box_qp_fused(*qp, warm=warm, **kw)
    warm_p = solve_box_qp_batched(*qp, warm=warm, **kw)
    k2_err = max(k2_err, compare_solutions(warm_k, warm_p, x_true, cert, "K2 warm"))
    k2_cold_ms = cuda_ms(lambda: solve_box_qp_fused(*qp, **kw), 5)
    k2_cold_plain_ms = cuda_ms(lambda: solve_box_qp_batched(*qp, **kw), 2)
    k2_ms = cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 10)
    k2_plain_ms = cuda_ms(lambda: solve_box_qp_batched(*qp, warm=warm, **kw), 3)
    print(f"K2 time: cold kernel {k2_cold_ms:.3f} ms, plain {k2_cold_plain_ms:.3f} ms; "
          f"warm kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms; active rows a of the "
          f"accepted polishes p50/p90/p99/max cold {active_rows(cold_k)}, warm "
          f"{active_rows(warm_k)}; {admm_bucket_report(('K2', 'A/B-2'))}")
    k2_bound_ms, k2_bound_by = solve_bound(qp, warm_k, kw["iters"], kw["ruiz_iters"], True)
    # canonical K1, K2, A/B-1 and A/B-2 give their pinned outputs bit for bit
    digests = kernel_digests(k1_args, kw)
    print(f"digests of canonical K1, K2, A/B-1 and A/B-2 outputs {digests}, pinned "
          f"{pinned()}")
    check(digests == pinned(), "K1/K2/A/B-1/A/B-2 outputs differ from their pinned digests")
    lap("5 K2")

    # ---- 6. the slice, closed loop: 1 cold + N_WARM warm ticks ----
    tick = tick_loop("6 tick loop", cfg, inputs,
                     expected(build_qp=1 + N_WARM, solve_box_qp_fused=1 + N_WARM))
    torch.cuda.empty_cache()

    k3 = phase_k3(dev)
    fleet = phase_fleet(dev)
    torch.cuda.empty_cache()
    k4 = phase_beam(dev, k3)
    torch.cuda.empty_cache()
    geom_fleet = phase_geom_fleet(dev)
    torch.cuda.empty_cache()
    twin = phase_two_launch(qp, kw, warm, cold_k, warm_k, x_true, cert)
    del x_true, cert
    jerk = phase_jerk_qp(states0, oa, od, ref)
    jerk_cfg = dataclasses.replace(MPCConfig.with_jerk(), T=T)
    jerk_tick = tick_loop("15 jerk tick loop", jerk_cfg, inputs,
                          expected(build_qp=1 + N_WARM, solve_box_qp_fused=1 + N_WARM),
                          p95_gate=False)
    unpolished = tick_loop("16 unpolished tick loop", dataclasses.replace(cfg, polish=False),
                           inputs, expected(build_qp=1 + N_WARM, ruiz_admm_all_rounds=1 + N_WARM),
                           p95_gate=False)
    jerk_fleet = phase_jerk_fleet(dev, fleet)
    torch.cuda.empty_cache()
    probes = phase_probes(dev, qp_k, cfg)
    profile = phase_profile_controller(dev)
    phase_profile_engine(dev)
    torch.cuda.empty_cache()
    drivers = phase_drivers(dev, smi_line)
    multi = phase_multi_ego(dev, smi_line)
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(dev, fleet)
    sweeps = phase_sweeps_live(dev, smi_line)
    cli = phase_cli(dev, smi_line, kind)
    torch.cuda.empty_cache()
    long = phase_long_horizon(dev, smi_line)
    torch.cuda.empty_cache()
    long_fleet = phase_long_fleet(dev, smi_line)
    print(f"warm tick, median over the loop: canonical {tick['loop_ms']:.2f} ms, jerk "
          f"{jerk_tick['loop_ms']:.2f} ms ({jerk_tick['loop_ms'] / tick['loop_ms'] - 1:+.1%}), "
          f"unpolished {unpolished['loop_ms']:.2f} ms "
          f"({unpolished['loop_ms'] / tick['loop_ms'] - 1:+.1%})")
    # launches: each kernel's count from its main path's run (K1/K2: phase
    # 6's loop, A/B-1: the unpolished loop, A/B-2: the two-launch solve, K1's
    # jerk mode: the jerk loop), the other paths' counts beside them
    print(json.dumps({"kernels": [
        {"name": "build_qp", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": tick["launches"]["build_qp"],
         "launches_fleet_path": fleet["launches"]["build_qp"],
         "launches_geom_fleet_path": geom_fleet["launches"]["build_qp"],
         "launches_unpolished_path": unpolished["launches"]["build_qp"],
         "launches_single_scenario_path": drivers["launches"]["build_qp"],
         "launches_multi_ego_path": multi["launches"]["build_qp"],
         "launches_multi_ego_fleet_path": multi["large"][-1]["launches"]["build_qp"],
         "launches_long_fleet_path": long_fleet["launches"]["build_qp"],
         "launches_checkpoint_path": ckpt["launches"]["build_qp"],
         "launches_sweep_path": sweeps["sweep_launches"]["build_qp"],
         "launches_live_path": sweeps["live_launches"]["build_qp"],
         "launches_cli_path": cli["build_qp"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "solve_box_qp_fused", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": tick["launches"]["solve_box_qp_fused"],
         "launches_fleet_path": fleet["launches"]["solve_box_qp_fused"],
         "launches_geom_fleet_path": geom_fleet["launches"]["solve_box_qp_fused"],
         "launches_jerk_path": jerk_tick["launches"]["solve_box_qp_fused"],
         "launches_jerk_fleet_path": jerk_fleet["launches"]["solve_box_qp_fused"],
         "launches_single_scenario_path": drivers["launches"]["solve_box_qp_fused"],
         "launches_multi_ego_path": multi["launches"]["solve_box_qp_fused"],
         "launches_multi_ego_fleet_path": multi["large"][-1]["launches"]["solve_box_qp_fused"],
         "launches_checkpoint_path": ckpt["launches"]["solve_box_qp_fused"],
         "launches_sweep_path": sweeps["sweep_launches"]["solve_box_qp_fused"],
         "launches_live_path": sweeps["live_launches"]["solve_box_qp_fused"],
         "launches_cli_path": cli["solve_box_qp_fused"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": None},
        {"name": "astar_search", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": fleet["launches"]["astar_search"],
         "launches_cli_path": cli["astar_search"],
         "launches_long_fleet_path": long_fleet["launches"]["astar_search"],
         "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
        {"name": "frontier_collision", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": k4["launches"], "max_abs_err": k4["err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
        {"name": "ruiz_admm_all_rounds", "route": "cuda", "source": K2_SOURCE,
         "replaces": AB1_REPLACES, "launches": unpolished["launches"]["ruiz_admm_all_rounds"],
         "launches_two_launch_path": twin["launches"]["ruiz_admm_all_rounds"],
         "launches_single_scenario_path": drivers["unpolished_launches"]["ruiz_admm_all_rounds"],
         "max_abs_err": twin["ab1_err"], "ms": twin["ab1_ms"], "plain_ms": twin["ab1_plain_ms"],
         "bound_ms": twin["ab1_bound_ms"], "bound_by": twin["ab1_bound_by"], "library_ms": None},
        {"name": "polish_select", "route": "cuda", "source": K2_SOURCE,
         "replaces": AB2_REPLACES, "launches": twin["launches"]["polish_select"],
         "max_abs_err": twin["ab2_err"], "ms": twin["ab2_ms"], "plain_ms": twin["ab2_plain_ms"],
         "bound_ms": twin["ab2_bound_ms"], "bound_by": twin["ab2_bound_by"], "library_ms": None},
        {"name": "build_qp_jerk", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES + " (jerk=True)", "launches": jerk_tick["launches"]["build_qp"],
         "launches_fleet_path": jerk_fleet["launches"]["build_qp"],
         "launches_single_scenario_path": drivers["jerk_launches"]["build_qp"],
         "max_abs_err": jerk["k1_err"], "ms": jerk["k1_ms"], "plain_ms": jerk["k1_plain_ms"],
         "bound_ms": jerk["k1_bound_ms"], "bound_by": jerk["k1_bound_by"], "library_ms": None},
    ] + long_horizon_kernels(long, long_fleet) + [
        {"name": name, "route": "cuda", "source": K2_SOURCE, "replaces": PROBE_REPLACES[name],
         "launches": profile["launches"][name], "max_abs_err": probes[name]["err"],
         "ms": probes[name]["ms"], "plain_ms": probes[name]["plain_ms"],
         "bound_ms": probes[name]["bound_ms"], "bound_by": probes[name]["bound_by"],
         "library_ms": None}
        for name in PROBE_REPLACES]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


# Phase 26: MPCConfig(T=40, dt=0.1) (a 4 s look-ahead at 10 Hz) and
# MPCConfig(T=48, dt=0.1), past one CTA's shared memory: K2, A/B-1 and
# A/B-2 run a scenario on a cluster of CTAs (csrc/admm.cu).
LONG_T, LONG_DT = 40, 0.1
LONG48_T, LONG48_B = 48, 1024
LONG_PINS = ("k2_t40_cold", "k2_t40_warm", "ab1_t40")


def plain_share_bar(share, rows):
    """The solved share a kernel must reach past T=31 where the plain
    version solves ``share`` of ``rows``: 98%, or the plain version's less
    1% of the rows (two at least) where that is lower. At these horizons a
    few percent of the rows sit at the edge of the solved gate
    (``SOLVED_PRIM_MAX``) and two float32 solvers decide different ones
    there: at T=40, dt=0.1, B=4096 (phase 26 on an NVIDIA H100 80GB HBM3 at
    700 W) the kernel path's jerk tick solved 9 rows fewer than the plain
    tick on one tick, 1 more on the canonical tick's hardest (PERF.md). The slack is the 1% of ``compare_solutions``'
    and ``tick_loop``'s tail bars."""
    return min(0.98, share - max(2, rows // 100) / rows)


def long_horizon_bars(plain, cert):
    """``compare_solutions``' (min_certified, min_solved) past T=31: where
    the float64 reference certifies under 95% of the rows, the kernel is
    held to the plain version on the rows it certifies (at least 90% of
    them); the solved share ``plain_share_bar``. At these horizons neither
    the float64 reference nor 16 blocks of ADMM reach every row
    (tests/test_torch_kernels_cuda.py:228-241)."""
    rows = plain.x.shape[0]
    share = float(solved_mask(plain).float().mean())
    return (0.95 if float(cert.float().mean()) >= 0.95 else 0.9), plain_share_bar(share, rows)


def long_digests(k1_args, kw):
    """Digests of K2's outputs on the T=40 headline QP, cold and warm from
    its own cold solution, and of A/B-1's cold (all on clusters of two
    CTAs)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        ruiz_admm_all_rounds,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    qp_k = build_qp(*k1_args)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    cold = solve_box_qp_fused(*qp, **kw)
    warm = solve_box_qp_fused(*qp, warm=(cold.x, cold.y, cold.rho), **kw)
    return {"k2_t40_cold": _solution_digest(cold), "k2_t40_warm": _solution_digest(warm),
            "ab1_t40": _solution_digest(ruiz_admm_all_rounds(*qp, **kw))}


def long_inputs(dev, cfg, rows=None):
    """The headline generator's inputs at ``cfg``'s horizon (the first
    ``rows``, all B by default) and K1's arguments of its cold tick under
    ``cfg``."""
    from mpc_for_av_at_intersection_tpu_torch.mpc import init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference

    rows = rows or B
    inputs, oa, od, _ = headline_inputs(dev, horizon=cfg.T)
    inputs = tuple(t[:rows] for t in inputs)
    cs0 = init_controller_state(cfg, device=dev, batch=rows)
    ref = compute_reference(*inputs, cs0.target_idx, cs0.ov, cs0.have_ov, cfg.T, cfg.dt)
    return inputs, k1_inputs(inputs, oa[:rows], od[:rows], ref, cfg)


def cluster_report(n, m):
    """{kernel: "C CTAs a scenario, R B a CTA, A clusters at once, S CTAs/SM,
    registers, stack, spills"} for K2, A/B-1 and A/B-2 at (n, m), as the
    library counts them, with ptxas's numbers of the instantiation that
    runs (the cluster variant where C > 1)."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, admm

    lib = _build.load()
    out = {}
    for i, (label, kernel) in enumerate(ADMM_KERNELS[:3]):
        C = admm.cluster_size(i, n, m)
        name = kernel.replace("_kernel", "_cluster_kernel") if C > 1 else kernel
        u = _usage(name, admm_bucket(n, m) if C == 1 else
                   admm_cluster_bucket(n, m) if i < 2 else None)
        active = lib.admm_active_clusters(i, n, m, C) if C > 1 else None
        out[label] = (f"{C} CTAs a scenario, {admm.rank_bytes(i, n, m, C)} B a CTA, "
                      f"{active} clusters at once, {lib.admm_blocks_per_sm(i, n, m)} CTAs/SM, "
                      f"{u.get('regs')} registers, {u.get('stack')} B stack, "
                      f"{u.get('spill')} B spilled")
    return out


def both_solvers(run):
    """Call ``run`` with every QP solve of ``mpc_step_batched`` also done by
    the plain solver on the same QP (the tick keeps the kernel's result);
    returns, per solve, whether the kernel's and the plain solver's
    solutions pass the tick's ``solved`` gate."""
    from mpc_for_av_at_intersection_tpu_torch.mpc import batch
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched

    solve, seen = batch.solve_box_qp, []

    def both(P, q, G, lo, hi, polish=True, **kw):
        kern = solve(P, q, G, lo, hi, polish=polish, **kw)
        plain = solve_box_qp_batched(P, q, G, lo, hi, polish=polish, **kw)
        seen.append((bool(solved_mask(kern).all()), bool(solved_mask(plain).all())))
        return kern

    batch.solve_box_qp = both
    try:
        run()
    finally:
        batch.solve_box_qp = solve
    return seen


def phase_long_horizon(dev, smi_line):
    """Phase 26: horizons past one CTA's shared memory, on the entry points
    a user calls. ``mpc_step_batched`` under ``MPCConfig(T=40, dt=0.1)`` at
    the headline width (B=4096, N=512), closed loop as phase 6, canonical,
    jerk (n = 81) and unpolished: K1, then K2 (A/B-1 unpolished) on a
    cluster of two CTAs a scenario, each tick's launches counted. On the
    canonical tick's cold QP: K2 cold and warm, A/B-1 and A/B-2 against
    their plain versions and the float64 optimum (``long_horizon_bars``),
    the two-launch solve bit for bit K2, every kernel timed beside its
    plain version and bound, and the outputs held to their pins
    (``LONG_PINS``); K2 at n = 81 likewise. One cold tick at T=48, B=1024
    (K2 on two CTAs), against the plain tick and, on its QP, the float64
    optimum. The flagship driver under T=40, dt=0.1 through ``run_episode``
    to its end, replayed on the CPU plain path."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig, run_episode
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
        polish_and_select,
        ruiz_admm_batched,
        solve_box_qp_batched,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops import admm
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

    t_phase = time.perf_counter()
    wheelbase = bicycle_geometry().wheelbase
    cfg = MPCConfig(T=LONG_T, dt=LONG_DT)
    jerk_cfg = dataclasses.replace(MPCConfig.with_jerk(), T=LONG_T, dt=LONG_DT)
    n, m = cfg.qp_dims
    check(admm.cluster_size(admm.K2, n, m) == 2 and admm.cluster_size(admm.AB1, n, m) == 2
          and admm.cluster_size(admm.AB2, n, m) == 2, f"T={LONG_T}: not on two CTAs")
    inputs, k1_args = long_inputs(dev, cfg)
    out = {"cluster": {"T=40": 2, "jerk T=40": 2, "T=48": admm.cluster_size(
        admm.K2, *MPCConfig(T=LONG48_T).qp_dims)}}

    # ---- the slice's main path: three tick configurations, closed loop ----
    # Every row of ticks 0 and 20 is re-run on the card, in float32 and in
    # float64. No tick's controls are gated against the float32 plain path
    # (phase 6's p95 < 2e-3): at T=40 the float32 plain path itself is off
    # the float64 tick by ~0.23 at p90 on the cold tick (an NVIDIA H100
    # 80GB HBM3 at 700 W, this phase's inputs), so two float32
    # solvers part there; each is held to the float64 tick instead, at p50
    # and p90 and by the tail count. The p99 is printed, not gated: on warm
    # ticks K2's own arithmetic (the single-CTA kernel's, bit for bit) puts
    # ~1% of the rows farther from the float64 tick than the float32 plain
    # solver does, at T=20 too (``--long-horizon-numerics``, PERF.md).
    per = 1 + N_WARM
    kw_loop = dict(p95_gate=False, long_horizon=True)
    out["tick"] = tick_loop("26 T=40 tick loop", cfg, inputs, expected(
        build_qp=per, solve_box_qp_fused=per, solve_box_qp_fused_cluster=per), **kw_loop)
    out["jerk_tick"] = tick_loop("26 T=40 jerk tick loop", jerk_cfg, inputs, expected(
        build_qp=per, solve_box_qp_fused=per, solve_box_qp_fused_cluster=per), **kw_loop)
    out["unpolished_tick"] = tick_loop(
        "26 T=40 unpolished tick loop", dataclasses.replace(cfg, polish=False), inputs,
        expected(build_qp=per, ruiz_admm_all_rounds=per, ruiz_admm_all_rounds_cluster=per),
        **kw_loop)
    torch.cuda.empty_cache()

    # ---- the canonical cold QP: each kernel against its plain version ----
    kw = solver_kw(cfg)
    qp_k = build_qp(*k1_args)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    x_true, cert = true_solution(qp)
    cold_k, cold_p = solve_box_qp_fused(*qp, **kw), solve_box_qp_batched(*qp, **kw)
    err = compare_solutions(cold_k, cold_p, x_true, cert, "26 K2 T=40 cold",
                            *long_horizon_bars(cold_p, cert))
    warm = (cold_p.x, cold_p.y, cold_p.rho)
    warm_k = solve_box_qp_fused(*qp, warm=warm, **kw)
    warm_p = solve_box_qp_batched(*qp, warm=warm, **kw)
    err = max(err, compare_solutions(warm_k, warm_p, x_true, cert, "26 K2 T=40 warm",
                                     *long_horizon_bars(warm_p, cert)))
    reset_launches()
    twin = (solve_box_qp(*qp, fused=False, **kw), solve_box_qp(*qp, fused=False, warm=warm, **kw))
    torch.cuda.synchronize()
    twin_launches = read_launches()
    check(twin_launches == expected(ruiz_admm_all_rounds=2, polish_select=2,
                                    ruiz_admm_all_rounds_cluster=2, polish_select_cluster=2),
          f"T=40 two-launch solve: launches {twin_launches}")
    for tag, a, b in (("cold", twin[0], cold_k), ("warm", twin[1], warm_k)):
        differ = [f for f in a._fields if not same_bits(getattr(a, f), getattr(b, f))]
        check(not differ, f"T=40 two-launch solve {tag}: differs from K2 in {differ}")
    ab1_k = ruiz_admm_all_rounds(*qp, warm=warm, **kw)
    ab1_p = ruiz_admm_batched(*qp, warm=warm, **kw)
    compare_solutions(ab1_k, ab1_p, x_true, cert, "26 A/B-1 T=40 warm",
                      *long_horizon_bars(ab1_p, cert))
    ab1_err = float((ab1_k.x - ab1_p.x).abs().max())
    ab2_k, ab2_p = polish_select(*qp, ab1_k), polish_and_select(*qp, ab1_k)
    ab2_err = compare_solutions(ab2_k, ab2_p, x_true, cert, "26 A/B-2 T=40 warm",
                                *long_horizon_bars(ab2_p, cert))
    times = {
        "K2 cold": cuda_ms(lambda: solve_box_qp_fused(*qp, **kw), 3),
        "K2 warm": cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 5),
        "A/B-1 warm": cuda_ms(lambda: ruiz_admm_all_rounds(*qp, warm=warm, **kw), 5),
        "A/B-2": cuda_ms(lambda: polish_select(*qp, ab1_k), 5),
        "K2 cold plain": cuda_ms(lambda: solve_box_qp_batched(*qp, **kw), 2),
        "K2 warm plain": cuda_ms(lambda: solve_box_qp_batched(*qp, warm=warm, **kw), 2),
        "A/B-1 warm plain": cuda_ms(lambda: ruiz_admm_batched(*qp, warm=warm, **kw), 2),
        "A/B-2 plain": cuda_ms(lambda: polish_and_select(*qp, ab1_k), 2)}
    its, ruiz = kw["iters"], kw["ruiz_iters"]
    bounds = {"K2 warm": solve_bound(qp, warm_k, its, ruiz, True),
              "K2 cold": solve_bound(qp, cold_k, its, ruiz, False),
              "A/B-1 warm": solve_bound(qp, ab1_k, its, ruiz, True, polish=False),
              "A/B-2": solve_bound(qp, ab2_k, its, ruiz, True, admm=False)}
    digests = long_digests(k1_args, kw)
    print(f"digests of the T=40 cluster outputs {digests} (checked at the end of the phase)")
    shares = {k: float(solved_mask(v).float().mean()) for k, v in (
        ("K2 cold", cold_k), ("K2 warm", warm_k), ("A/B-1 warm", ab1_k), ("A/B-2", ab2_k))}
    print(f"26 T=40 (n={n}, m={m}), B={B}: " + "; ".join(
        f"{k} {times[k]:.3f} ms (plain {times[k + ' plain']:.3f}, bound {bounds[k][0]:.4f} "
        f"{bounds[k][1]}, solved {shares[k]:.4f})" for k in bounds)
        + f"; two-launch bit-identical to K2, cold and warm, launches {_nonzero(twin_launches)}; "
        f"{cluster_report(n, m)}; active rows a of K2 warm {active_rows(warm_k)} [{smi_line}]")
    out.update(k2_err=err, ab1_err=ab1_err, ab2_err=ab2_err, times=times, bounds=bounds,
               twin_launches=twin_launches, digests=digests)
    del x_true, cert

    # ---- K2 at the jerk variant's n = 81 ----
    jerk_args = k1_args[:5] + (jerk_cfg,) + k1_args[6:]
    jq = build_qp(*jerk_args)
    jqp = (jq.P, jq.q, jq.G, jq.lo, jq.hi)
    jkw = solver_kw(jerk_cfg)
    x_true, cert = true_solution(jqp)
    jcold_p = solve_box_qp_batched(*jqp, **jkw)
    jerr = compare_solutions(solve_box_qp_fused(*jqp, **jkw), jcold_p, x_true, cert,
                             f"26 K2 jerk T=40 n={jq.q.shape[1]} cold",
                             *long_horizon_bars(jcold_p, cert))
    jwarm = (jcold_p.x, jcold_p.y, jcold_p.rho)
    jwarm_k, jwarm_p = (solve_box_qp_fused(*jqp, warm=jwarm, **jkw),
                        solve_box_qp_batched(*jqp, warm=jwarm, **jkw))
    jerr = max(jerr, compare_solutions(jwarm_k, jwarm_p, x_true, cert,
                                       f"26 K2 jerk T=40 n={jq.q.shape[1]} warm",
                                       *long_horizon_bars(jwarm_p, cert)))
    jtimes = (cuda_ms(lambda: solve_box_qp_fused(*jqp, warm=jwarm, **jkw), 5),
              cuda_ms(lambda: solve_box_qp_batched(*jqp, warm=jwarm, **jkw), 2))
    jbound = solve_bound(jqp, jwarm_k, jkw["iters"], jkw["ruiz_iters"], True)
    print(f"26 K2 jerk T=40 (n={jq.q.shape[1]}): warm {jtimes[0]:.3f} ms (plain "
          f"{jtimes[1]:.3f}, bound {jbound[0]:.4f} {jbound[1]}, solved "
          f"{float(solved_mask(jwarm_k).float().mean()):.4f}); "
          f"{cluster_report(jq.q.shape[1], m)['K2']} [{smi_line}]")
    out["jerk"] = {"err": jerr, "ms": jtimes[0], "plain_ms": jtimes[1], "bound": jbound}
    del x_true, cert, jq, jqp
    torch.cuda.empty_cache()

    # ---- one cold tick at T=48, B=1024: K2 on a cluster ----
    cfg48 = MPCConfig(T=LONG48_T, dt=LONG_DT)
    inputs48, args48 = long_inputs(dev, cfg48, LONG48_B)
    cs48 = init_controller_state(cfg48, device=dev, batch=LONG48_B)
    reset_launches()
    tick48 = mpc_step_batched(*inputs48, cs48, cfg48, wheelbase)
    torch.cuda.synchronize()
    launches48 = read_launches()
    check(launches48 == expected(build_qp=1, solve_box_qp_fused=1, solve_box_qp_fused_cluster=1),
          f"T=48 tick: launches {launches48}")
    plain48 = _mpc_step(*inputs48, cs48, cfg48, wheelbase, build_qp_reference,
                        solve_box_qp_batched)
    s48, p48 = (float(t.solved.float().mean()) for t in (tick48, plain48))
    check(s48 >= plain_share_bar(p48, LONG48_B), f"T=48 tick: solved {s48}, plain {p48}")
    q48 = build_qp(*args48)
    qp48 = (q48.P, q48.q, q48.G, q48.lo, q48.hi)
    kw48 = solver_kw(cfg48)
    x_true, cert = true_solution(qp48)
    k48, pl48 = solve_box_qp_fused(*qp48, **kw48), solve_box_qp_batched(*qp48, **kw48)
    err48 = compare_solutions(k48, pl48, x_true, cert, "26 K2 T=48 B=1024 cold",
                              *long_horizon_bars(pl48, cert))
    t48 = (cuda_ms(lambda: solve_box_qp_fused(*qp48, **kw48), 3),
           cuda_ms(lambda: solve_box_qp_batched(*qp48, **kw48), 2))
    b48 = solve_bound(qp48, k48, kw48["iters"], kw48["ruiz_iters"], False)
    n48, m48 = cfg48.qp_dims
    print(f"26 T=48 (n={n48}, m={m48}), B={LONG48_B}: cold tick solved {s48:.4f} (plain tick "
          f"{p48:.4f}), launches {_nonzero(launches48)}; K2 cold {t48[0]:.3f} ms (plain "
          f"{t48[1]:.3f}, bound {b48[0]:.4f} {b48[1]}); {cluster_report(n48, m48)['K2']} "
          f"[{smi_line}]")
    out["t48"] = {"launches": launches48, "err": err48, "ms": t48[0], "plain_ms": t48[1],
                  "bound": b48}
    del x_true, cert, qp48, q48
    torch.cuda.empty_cache()

    # ---- the flagship driver at T=40, dt=0.1, to the end of its episode ----
    ecfg = EngineConfig(mpc=cfg)
    setup = api.build_intersection(cfg=ecfg, device=dev)
    steps = int(setup.state0.ticks_to_goal)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, steps)
    done = bool(final.done)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    ep_launches = read_launches()
    check(ep_launches == expected(build_qp=steps, solve_box_qp_fused=steps,
                                  solve_box_qp_fused_cluster=steps),
          f"T=40 flagship: launches {ep_launches}")
    k = int(final.ticks_to_goal)
    gap = _goal_gap(setup.trajectory, tel, k)
    check(done and gap < 1.6, f"T=40 flagship: done {done} at {k}, goal gap {gap}")
    # At T=40 a few of the episode's own QPs are left unsolved by the plain
    # solver too (the algorithm at this horizon), so phase 21's "every tick
    # solved" becomes: the same episode again (bit for bit), each tick's QP
    # also solved by the plain solver on the card; the kernel may leave
    # unsolved at most one tick more than the plain solver does.
    seen = both_solvers(lambda: run_episode(setup.world, setup.state0, setup.cfg, setup.geom,
                                            steps))[:k]
    unsolved = [i for i in range(k) if not bool(tel.solved[i])]
    check(unsolved == [i for i, (ok, _) in enumerate(seen) if not ok],
          "T=40 flagship: the repeated episode differs")
    k_only = [i for i, (ok, ok_p) in enumerate(seen) if ok_p and not ok]
    p_only = [i for i, (ok, ok_p) in enumerate(seen) if ok and not ok_p]
    check(len(k_only) <= len(p_only) + 1, f"T=40 flagship: the kernel leaves ticks {k_only} "
          f"unsolved, the plain solver on the same QPs {p_only}")
    # the CPU plain path's own episode: its unsolved ticks (a max-decel
    # tick each) fall elsewhere, so its arrival is compared, not its tick
    cpu = api.build_intersection(cfg=ecfg, device="cpu")
    cfinal, ctel = run_episode(cpu.world, cpu.state0, cpu.cfg, cpu.geom, steps)
    kc = int(cfinal.ticks_to_goal)
    both = min(k, kc)
    pos_gap = float(torch.hypot(tel.x[:both].cpu() - ctel.x[:both],
                                tel.y[:both].cpu() - ctel.y[:both]).max())
    check(bool(cfinal.done) and _goal_gap(cpu.trajectory, ctel, kc) < 1.6,
          f"T=40 flagship: CPU plain path done {bool(cfinal.done)} at {kc}")
    print(f"26 flagship T=40 dt=0.1: {steps} ticks, done at {k}, goal gap {gap:.3f} m, "
          f"conflict ticks {int(tel.collision_found.sum())}, unsolved ticks {unsolved} (the "
          f"plain solver on the same QPs: {[i for i, (_, ok) in enumerate(seen) if not ok]}), "
          f"launches {_nonzero(ep_launches)}, {ms:.2f} ms per tick at B=1; CPU plain path done "
          f"at {kc}, unsolved ticks {int((~ctel.solved[:kc]).sum())}, largest position gap "
          f"over the {both} ticks both ran {pos_gap:.3g} m [{smi_line}]")
    out["episode_launches"] = ep_launches

    # ---- pins last, once every number above is printed ----
    print(f"digests of the T=40 cluster outputs {digests}, pinned {pinned(*LONG_PINS)}")
    check(digests == pinned(*LONG_PINS), "T=40 cluster outputs differ from their pinned digests")
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s")
    lap("26 long horizon")
    return out


# Phase 27: the fleet under MPCConfig(T=40, dt=0.1): phase 9's 1024
# scenarios for the same 6.4 s of simulated time (64 ticks at dt=0.1).
LONG_FLEET_B, LONG_FLEET_T = 1024, 64


def phase_long_fleet(dev, smi_line):
    """Phase 27: the long-horizon fleet. ``sample_intersection_fleet_batched``
    (LONG_FLEET_B scenarios, K3 on the card) and ``run_batch_episodes``
    under ``EngineConfig(mpc=MPCConfig(T=40, dt=0.1))`` for LONG_FLEET_T
    ticks: K1 at n = 80 on one CTA and K2 on clusters of two CTAs once a
    tick, K3 once, every course from K3, states finite. Each tick's solved
    share over the live rows at least ``plain_share_bar`` of the plain
    path's run on the card (``run_fleet_episodes(use_kernels=False)``),
    ticks 0 and the last against the CPU plain path
    (``compare_with_cpu_plain(long_horizon=True)``); scenario ticks/s
    through the kernels and on the plain path, K2's share of a tick and
    the peak memory."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig, run_fleet_episodes
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.ops import admm
    from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes

    t_phase = time.perf_counter()
    cfg = EngineConfig(mpc=MPCConfig(T=LONG_T, dt=LONG_DT))
    n, m = cfg.mpc.qp_dims
    check(admm.cluster_size(admm.K2, n, m) == 2, f"T={LONG_T} fleet: K2 not on two CTAs")
    Tn = LONG_FLEET_T
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    geom, world, state, meta = api.sample_intersection_fleet_batched(
        LONG_FLEET_B, np.random.default_rng(SEED), cfg=cfg, n_steps=Tn, planner="device",
        device=dev)
    final, tel, summary = run_batch_episodes(world, state, cfg, geom, Tn)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(launches == expected(build_qp=Tn, solve_box_qp_fused=Tn,
                               solve_box_qp_fused_cluster=Tn, astar_search=1),
          f"T={LONG_T} fleet launches {launches}")
    stats = meta["planner_stats"]
    n_keys = len(set(zip(meta["start_pos"].tolist(), meta["turn_indicator"].tolist())))
    check(stats["n_host_fallback"] == 0 and stats["n_device"] == n_keys,
          f"T={LONG_T} fleet planner: {stats['n_device']} courses from K3, "
          f"{stats['n_host_fallback']} host fallbacks, {n_keys} (start, turn) keys")
    check(bool(final.ego.isfinite().all()) and bool(tel.x.isfinite().all())
          and bool(tel.steer.isfinite().all()), f"T={LONG_T} fleet: states went non-finite")

    # the plain path on the card: its own run, timed; each tick's share
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ptel = run_fleet_episodes(world, state, cfg, geom, Tn, use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    shares, low = [], []
    for t in range(Tn):
        live, plive = ~tel.done[:, t], ~ptel.done[t]
        share = float(tel.solved[live, t].float().mean()) if bool(live.any()) else 1.0
        pshare = float(ptel.solved[t][plive].float().mean()) if bool(plive.any()) else 1.0
        bar = plain_share_bar(pshare, max(int(plive.sum()), 1))
        shares.append(share)
        if share < 0.98:
            low.append(f"tick {t} {share:.4f} (plain {pshare:.4f})")
        check(share >= bar, f"T={LONG_T} fleet tick {t}: solved share over live rows {share} < "
              f"{bar} (plain path {pshare})")

    # the bench bracket of phase 9: a second run, host clock, ended by a
    # value fetch
    t0 = time.perf_counter()
    _, _, again = run_batch_episodes(world, state, cfg, geom, Tn)
    int(again["n_done"])
    fleet_s = time.perf_counter() - t0
    prof = fleet_profile(world, state, cfg, geom, tag=f"T={LONG_T} fleet tick")
    k2_ms = sum(v for k, v in prof["by_kernel"].items() if "solve_polish_cluster_kernel" in k)
    tick_ms = fleet_s * 1e3 / Tn
    print(f"27 fleet T={LONG_T} dt={LONG_DT}: {LONG_FLEET_B} scenarios x {Tn} ticks; launches "
          f"{_nonzero(launches)}; planner {stats['n_device']} courses on the card, "
          f"{stats['n_host_fallback']} host fallbacks, {stats['seconds']:.2f} s; solved share over "
          f"live rows min {min(shares):.4f}{' (under 98%: ' + ', '.join(low) + ')' if low else ''}; "
          f"done {int(summary['n_done'])}, unsolved ticks {int(summary['n_unsolved_ticks'])}, "
          f"collisions flagged {int(tel.collision_found.sum())}; peak {peak:.2f} GiB "
          f"[{smi_line}]")
    print(f"27 fleet T={LONG_T} rate: {LONG_FLEET_B * Tn / fleet_s:.1f} scenario ticks/s through "
          f"the kernels ({tick_ms:.2f} ms per tick), plain path on the card "
          f"{LONG_FLEET_B * Tn / plain_s:.1f} ({plain_s * 1e3 / Tn:.2f} ms per tick); K2 "
          f"{k2_ms:.2f} ms a tick, {k2_ms / tick_ms:.1%} of the tick ({k2_ms / prof['wall_ms']:.1%}"
          f" of a {prof['wall_ms']:.2f} ms profiled tick) [{smi_line}]")

    compare_with_cpu_plain(f"T={LONG_T} fleet", world, state, cfg, geom, Tn - 1,
                           long_horizon=True)
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    lap("27 long-horizon fleet")
    return {"launches": launches, "ms": tick_ms, "plain_ms": plain_s * 1e3 / Tn,
            "k2_share": k2_ms / tick_ms, "peak_gib": peak}


DRIVERS = (   # (tag, api builder, keyword arguments, it has scripted traffic)
    ("flagship", "build_intersection", {}, True),
    ("basic-T 9", "build_t_intersection_basic", {"scenario_no": 9}, True),
    ("roundabout", "build_roundabout", {}, True),
    ("multi-lane", "build_intersection_multi_lane", {}, False),
    ("speed-ref", "build_intersection_speed_ref", {}, True),
    ("cyclist", "build_overtaking_cyclist", {}, True),
    ("flagship jerk", "build_intersection", {"jerk": True}, True),
    ("flagship unpolished", "build_intersection", {"polish": False}, True),
    ("two-ego crossing", "build_multi_ego_intersection", {}, False),
)


def _driver_setup(builder, kw, device):
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig

    kw = dict(kw)
    if kw.pop("jerk", False):
        kw["cfg"] = EngineConfig(mpc=MPCConfig.with_jerk())
    if not kw.pop("polish", True):
        kw["cfg"] = EngineConfig(mpc=MPCConfig(polish=False))
    return getattr(api, builder)(device=device, **kw)


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _goal_gap(trajectory, tel, k, e=None):
    """Distance from the goal of tick k-1's position (ego ``e``)."""
    x, y = tel.x[k - 1], tel.y[k - 1]
    if e is not None:
        x, y = x[e], y[e]
    return float(np.hypot(float(x) - trajectory[-1, 0], float(y) - trajectory[-1, 1]))


def _min_clearance(tel, geom):
    """Least distance between two egos' collision circles over every tick
    (telemetry (T, E))."""
    cc = torch.as_tensor(geom.circle_centers, dtype=torch.float64)
    x, y, yaw = (t.double().cpu() for t in (tel.x, tel.y, tel.yaw))
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    px = x[..., None] + c * cc[:, 0] - s * cc[:, 1]                  # (T, E, C)
    py = y[..., None] + s * cc[:, 0] + c * cc[:, 1]
    pts = torch.stack([px, py], -1).flatten(1, 2)                    # (T, E*C, 2)
    d = torch.cdist(pts, pts)
    E, C = x.shape[1], cc.shape[0]
    same = torch.arange(E).repeat_interleave(C)
    d[:, same[:, None] == same[None, :]] = float("inf")
    return float(d.min())


def phase_drivers(dev, smi_line):
    """Phase 21: the seven scenario drivers of ``api`` on the card at their
    defaults (basic-T at its ninth setup), each through ``run_episode`` at
    its ``n_steps`` (the multi-ego builder's two-ego crossing through
    ``run_multi_ego_episode``, each ego's subtick on its own), the flagship
    also under the jerk and the unpolished controller. Each episode's
    launch counts are reset just before it and read just after: K1 and K2
    (A/B-1 unpolished) n_steps x max(max_iter, 1) times, per ego. The
    outcome checks of tests/test_drivers.py, tests/test_engine.py and
    tests/test_multi_ego.py: done, the goal within 1.6 m, every tick
    solved, no conflict where the driver has no traffic, conflict ticks on
    the speed-ref driver, the egos' circles apart. The flagship and the
    speed-ref driver are replayed on the CPU plain path in float32: done
    equal, ticks to goal within 1. Host-clock ms per tick at B=1: the
    latency of one closed-loop tick (a record, no bar)."""
    from mpc_for_av_at_intersection_tpu_torch.engine import (
        engine_tick,
        run_episode,
        run_multi_ego_episode,
    )

    t_phase = time.perf_counter()
    out, rows = {}, []
    for tag, builder, kw, traffic in DRIVERS:
        setup = _driver_setup(builder, kw, dev)
        n_steps = int(setup.state0.ticks_to_goal.reshape(-1)[0])
        multi = setup.trajectories is not None
        run = run_multi_ego_episode if multi else run_episode
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, tel = run(setup.world, setup.state0, setup.cfg, setup.geom, n_steps)
        done = final.done.cpu()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        launches = read_launches()
        mpc = setup.cfg.mpc
        per = n_steps * max(mpc.max_iter, 1) * (len(setup.trajectories) if multi else 1)
        want = (expected(build_qp=per, solve_box_qp_fused=per) if mpc.polish
                else expected(build_qp=per, ruiz_admm_all_rounds=per))
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        check(bool(done.all()), f"{tag}: not done, end {final.ego if not multi else final.egos}")
        ks = final.ticks_to_goal.reshape(-1).tolist()
        trajs = setup.trajectories if multi else [setup.trajectory]
        gaps = [_goal_gap(tr, tel, k, e if multi else None) for e, (tr, k) in
                enumerate(zip(trajs, ks))]
        check(max(gaps) < 1.6, f"{tag}: goal gap {gaps}")
        check(bool(tel.solved.all()), f"{tag}: unsolved ticks")
        conflicts = int(tel.collision_found.sum())
        note = ""
        if not traffic and not multi:
            check(conflicts == 0, f"{tag}: {conflicts} conflict ticks without traffic")
        if tag == "speed-ref":
            check(bool(tel.collision_found[:ks[0]].any()), "speed-ref: no conflict tick")
        if multi:
            clear = _min_clearance(tel, setup.geom)
            check(clear > 2 * setup.geom.radius * 0.7, f"{tag}: ego-ego clearance {clear}")
            note = f", ego-ego clearance {clear:.2f} m"
        if tag in ("flagship", "speed-ref"):
            cpu_setup = _driver_setup(builder, kw, "cpu")
            cfinal, ctel = run_episode(cpu_setup.world, cpu_setup.state0, cpu_setup.cfg,
                                       cpu_setup.geom, n_steps)
            kc = int(cfinal.ticks_to_goal)
            both = min(ks[0], kc)
            gap = float(torch.hypot(tel.x[:both].cpu() - ctel.x[:both],
                                    tel.y[:both].cpu() - ctel.y[:both]).max())
            check(bool(cfinal.done) == bool(done) and abs(kc - ks[0]) <= 1,
                  f"{tag}: CPU plain path done {bool(cfinal.done)} at {kc}, card at {ks[0]}")
            note += (f"; CPU plain path: done at tick {kc}, largest position gap over the "
                     f"{both} ticks both ran {gap:.3g} m")
        print(f"{tag}: {n_steps} ticks, done at {ks}, goal gap {max(gaps):.3f} m, conflict "
              f"ticks {conflicts}, launches {_nonzero(launches)}, {ms:.2f} ms per tick at "
              f"B={len(trajs) if multi else 1}{note} [{smi_line}]")
        rows.append((tag, ms))
        if tag == "flagship":
            out["launches"] = launches
            tick_profile("flagship B=1 tick", lambda st: engine_tick(
                setup.world, st, setup.cfg, setup.geom)[0], setup.state0)
        elif tag == "flagship jerk":
            out["jerk_launches"] = launches
        elif tag == "flagship unpolished":
            out["unpolished_launches"] = launches
    print("single-scenario ms per tick at B=1: " + ", ".join(f"{t} {ms:.2f}" for t, ms in rows)
          + f"; phase {time.perf_counter() - t_phase:.1f} s [{smi_line}]")
    lap("21 drivers")
    return out


def eight_ego_junction(dev):
    """The 8-ego two-lane junction of
    tests/test_prius_and_fleet.py::test_eight_ego_intersection
    (EngineConfig(n_agents=2)): (world, cold state, cfg, geom)."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.agents import stack_agents
    from mpc_for_av_at_intersection_tpu_torch.engine import (
        EngineConfig,
        init_multi_ego_state,
        make_multi_ego_world,
    )
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.worlds import intersection_multi_lanes

    geom = bicycle_geometry()
    cfg = EngineConfig(n_agents=2)
    trajs = [api.plan_course(intersection_multi_lanes(
        turn_indicator=turn, start_pos=start, start_lane=lane, goal_lane=lane,
        number_of_lanes=2), geom) for start, turn, lane in ME_COMBOS]
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg, device=dev)
    return world, init_multi_ego_state(world, ag, cfg, ME_STEPS, device=dev), cfg, geom


def junction_copies(tree, S):
    """S copies of one junction's world or state along a leading axis."""
    from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map

    return tree_map(lambda a: a.expand((S,) + a.shape).contiguous(), tree)


def multi_ego_size(dev, world, st0, cfg, geom, S, smi_line, cpu_check=False):
    """ME_CHAIN chained ``multi_ego_fleet_tick``s of
    S copies of the junction from its cold state: one K1 and one K2 launch
    a tick, >= 98% of the live rows solved every tick; then the median of
    ME_REPS timed chains and the peak memory. Returns the size's row."""
    from mpc_for_av_at_intersection_tpu_torch.engine import multi_ego_fleet_tick

    E = st0.egos.shape[0]
    worldS, stS = junction_copies(world, S), junction_copies(st0, S)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    st, shares = stS, []
    for _ in range(ME_CHAIN):
        last = st
        st, tel = multi_ego_fleet_tick(worldS, st, cfg, geom)
        live = ~tel.done
        shares.append((tel.solved & live).sum() / live.sum().clamp(min=1))
    share = float(torch.stack(shares).min())
    launches = read_launches()
    check(launches == expected(build_qp=ME_CHAIN, solve_box_qp_fused=ME_CHAIN),
          f"multi-ego fleet S={S}: launches {launches}")
    check(share >= 0.98, f"multi-ego fleet S={S}: solved share of live rows {share}")
    if cpu_check:
        _multi_ego_vs_cpu(worldS, stS, cfg, geom, 0)
        _multi_ego_vs_cpu(worldS, last, cfg, geom, ME_CHAIN - 1)
    times = []
    for _ in range(ME_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = stS
        for _ in range(ME_CHAIN):
            st, _ = multi_ego_fleet_tick(worldS, st, cfg, geom)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / ME_CHAIN)
    tick_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    row = {"S": S, "egos": S * E, "tick_ms": tick_ms, "ego_solves_per_s": S * E / tick_ms * 1e3,
           "peak_gib": peak, "min_live_solved": share, "launches": launches}
    print(f"multi-ego fleet S={S} ({S * E} egos): {tick_ms:.2f} ms per tick (median of "
          f"{ME_REPS} x {ME_CHAIN} chained), {row['ego_solves_per_s']:.1f} ego solves/s, "
          f"peak {peak:.2f} GiB, live rows solved >= {share:.4f} [{smi_line}]")
    del worldS, stS, st, last
    torch.cuda.empty_cache()
    return row


def sliced_vs_whole(dev, world, st0, cfg, geom, S, smi_line):
    """S junctions' ME_CHAIN chained ticks with the conflict scan as the
    kernel (``check_collision_moving_cars``, the default) and as the plain
    torch scan in its default slices of rows (``collision.SCAN_ELEMENTS``)
    and whole (the budget raised to every row): every state and telemetry
    field of every tick equal bit for bit. Each run's peak memory, ME_REPS
    timed chains of each, alternating, and a profile of each."""
    from mpc_for_av_at_intersection_tpu_torch.agents import collision
    from mpc_for_av_at_intersection_tpu_torch.engine import closed_loop, multi_ego_fleet_tick

    E = st0.egos.shape[0]
    per_row = collision.scan_row_elements(E + cfg.n_agents, len(geom.circle_centers),
                                          cfg.frame_window, cfg.n_frames)
    sliced = collision.SCAN_ELEMENTS
    plain = collision.check_collision_moving_cars_reference
    paths = {"kernel": (collision.check_collision_moving_cars, sliced),
             "sliced": (plain, sliced), "whole": (plain, S * E * per_row)}
    n_slices = -(-S * E // max(1, sliced // per_row))
    worldS, stS = junction_copies(world, S), junction_copies(st0, S)
    tick = lambda x: multi_ego_fleet_tick(worldS, x, cfg, geom)   # noqa: E731

    def use(path):
        closed_loop.check_collision_moving_cars, collision.SCAN_ELEMENTS = paths[path]

    runs, peaks, times, profiles = {}, {}, {k: [] for k in paths}, {}
    try:
        for k in paths:
            use(k)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            st, ticks = stS, []
            for _ in range(ME_CHAIN):
                st, tel = tick(st)
                ticks.append((st, tel))
            torch.cuda.synchronize()
            runs[k], peaks[k] = tuple(ticks), torch.cuda.max_memory_allocated(dev) / 2**30
        differ = {k: [i for i, (a, b) in enumerate(zip(runs[k], runs["sliced"]))
                      if not _same_tree(a, b)] for k in ("kernel", "whole")}
        del runs
        for _ in range(ME_REPS):
            for k in paths:
                use(k)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = stS
                for _ in range(ME_CHAIN):
                    st, _ = tick(st)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3 / ME_CHAIN)
        for k in paths:
            use(k)
            profiles[k] = tick_profile(f"multi-ego fleet S={S}, scan {k}",
                                       lambda x: tick(x)[0], stS)
    finally:
        use("kernel")
    print(f"multi-ego fleet S={S}, conflict scan as the kernel against the plain torch scan in "
          f"{n_slices} slices of rows and whole: {ME_CHAIN} chained ticks bit-equal in every "
          f"state and telemetry field: kernel {not differ['kernel']}, whole "
          f"{not differ['whole']}; ms per tick kernel {sorted(times['kernel'])}, sliced "
          f"{sorted(times['sliced'])}, whole {sorted(times['whole'])} ({ME_REPS} x {ME_CHAIN} "
          f"chained, alternating); peak kernel {peaks['kernel']:.2f} GiB, sliced "
          f"{peaks['sliced']:.2f} GiB, whole {peaks['whole']:.2f} GiB [{smi_line}]")
    check(not differ["kernel"] and not differ["whole"],
          f"multi-ego fleet S={S}: the kernel's and the whole scan's ticks {differ} differ from "
          "the sliced plain scan's")
    del worldS, stS, st
    torch.cuda.empty_cache()
    return {"slices": n_slices, "ms": times, "peak_gib": peaks,
            "profile": {k: {"wall_ms": p["wall_ms"], "device_ms": p["device_ms"]}
                        for k, p in profiles.items()}}


def phase_multi_ego(dev, smi_line):
    """Phase 22: the multi-ego engine. The 8-ego two-lane junction
    (``eight_ego_junction``, 300 ticks) through ``run_multi_ego_episode``
    (E=8: the batched tick, one K1 and one K2 launch at B=8 a tick): at
    least 6 egos finish and no two egos' circles come closer than
    2 r 0.7. Then bench_multi_ego.py's sweep: S = 16 ... 1024 copies of
    the junction through ``multi_ego_fleet_tick`` (one K1 and one K2
    launch at B = 8 S a tick), ``multi_ego_size`` each, and the largest S
    under REALTIME_MS. S=16's first and last chained ticks are held to the
    same ticks on the CPU plain path (flags exact, controls p95 <= 2e-3 as
    phase 6). At S=1024 the tick with the conflict scan as the kernel and
    as the plain torch scan in its default slices of rows and whole
    (``sliced_vs_whole``): bit for bit, each one's time, peak memory and
    profile. Past the sweep, ME_LARGE junctions with
    the sweep's gates."""
    from mpc_for_av_at_intersection_tpu_torch.engine import run_multi_ego_episode

    t_phase = time.perf_counter()
    world, st0, cfg, geom = eight_ego_junction(dev)
    E = st0.egos.shape[0]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, tel = run_multi_ego_episode(world, st0, cfg, geom, ME_STEPS)
    n_done = int(final.done.sum())
    ep_ms = (time.perf_counter() - t0) * 1e3 / ME_STEPS
    ep_launches = read_launches()
    check(ep_launches == expected(build_qp=ME_STEPS, solve_box_qp_fused=ME_STEPS),
          f"8-ego junction launches {ep_launches}")
    clear = _min_clearance(tel, geom)
    print(f"8-ego junction: {ME_STEPS} ticks, {n_done}/{E} egos done (ticks to goal "
          f"{final.ticks_to_goal.tolist()}), ego-ego clearance {clear:.3f} m (bar "
          f"{2 * geom.radius * 0.7:.3f}), solved share {float(tel.solved.float().mean()):.4f}, "
          f"launches {_nonzero(ep_launches)}, {ep_ms:.2f} ms per tick at B={E} [{smi_line}]")
    check(n_done >= 6, f"8-ego junction: only {n_done}/{E} egos finished")
    check(clear > 2 * geom.radius * 0.7, f"8-ego junction: ego-ego clearance {clear}")

    sweep, best = [], None
    for S in ME_SWEEP:
        row = multi_ego_size(dev, world, st0, cfg, geom, S, smi_line, cpu_check=S == ME_SWEEP[0])
        sweep.append(row)
        if row["tick_ms"] <= REALTIME_MS:
            best = row
    print(f"multi-ego fleet: largest S under {REALTIME_MS:.0f} ms per tick: "
          f"{best['S'] if best else None} ({best['tick_ms'] if best else float('nan'):.2f} ms, "
          f"{best['ego_solves_per_s'] if best else float('nan'):.1f} ego solves/s) [{smi_line}]")
    scan = sliced_vs_whole(dev, world, st0, cfg, geom, ME_SWEEP[-1], smi_line)
    large = [multi_ego_size(dev, world, st0, cfg, geom, S, smi_line) for S in ME_LARGE]
    print("multi-ego fleet past the sweep: " + "; ".join(
        f"S={r['S']} ({r['egos']} egos) {r['tick_ms']:.2f} ms per tick, "
        f"{r['ego_solves_per_s']:.1f} ego solves/s, peak {r['peak_gib']:.2f} GiB" for r in large)
        + f"; phase {time.perf_counter() - t_phase:.1f} s [{smi_line}]")
    lap("22 multi-ego")
    return {"launches": ep_launches, "sweep": sweep, "scan": scan, "large": large}


def _multi_ego_vs_cpu(world, st, cfg, geom, tick):
    """One fleet tick on the card and on the CPU plain path from the same
    state: done, collision_found, cutoff_lens and agent_idxs exact,
    controls p95 <= 2e-3 over the rows both solved."""
    from mpc_for_av_at_intersection_tpu_torch.engine import multi_ego_fleet_tick
    from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map

    card_st, card_tel = multi_ego_fleet_tick(world, st, cfg, geom)
    cpu = lambda a: a.cpu()   # noqa: E731
    cpu_st, cpu_tel = multi_ego_fleet_tick(tree_map(cpu, world), tree_map(cpu, st), cfg, geom)
    exact = {
        "done": bool((card_tel.done.cpu() == cpu_tel.done).all()),
        "collision_found": bool((card_tel.collision_found.cpu() == cpu_tel.collision_found).all()),
        "cutoff_lens": bool((card_st.cutoff_lens.cpu() == cpu_st.cutoff_lens).all()),
        "agent_idxs": bool((card_st.agent_idxs.cpu() == cpu_st.agent_idxs).all()),
    }
    both = card_tel.solved.cpu() & cpu_tel.solved & ~cpu_tel.done
    d = torch.stack([(card_tel.accel.cpu() - cpu_tel.accel).abs(),
                     (card_tel.steer.cpu() - cpu_tel.steer).abs()], -1)[both]
    p95 = float(d.double().quantile(0.95, dim=0).max()) if len(d) else 0.0
    print(f"multi-ego fleet S={world.courses.shape[0]} tick {tick} vs CPU plain: exact {exact}, "
          f"{int(both.sum())} rows both solved, controls p95 {p95:.3g} (bar 2e-3), max "
          f"{float(d.max()) if len(d) else 0.0:.3g}")
    check(all(exact.values()), f"multi-ego fleet tick {tick} vs CPU: {exact}")
    check(int(both.sum()) >= 0.98 * int((~cpu_tel.done).sum()),
          f"multi-ego fleet tick {tick}: too few rows solved by both")
    check(p95 <= 2e-3, f"multi-ego fleet tick {tick} vs CPU: controls p95 {p95}")


def _same_tree(a, b):
    """Every tensor of two equal trees equal bit for bit."""
    if isinstance(a, tuple):
        return all(_same_tree(x, y) for x, y in zip(a, b))
    return same_bits(a, b)


def phase_checkpoint(dev, fleet):
    """Phase 23: checkpoint and resume on phase 9's fleet (1024 scenarios x
    32 ticks). The straight run, then ``utils.checkpoint.run_chunked`` in
    chunks of 8 broken off after 16 ticks and resumed from its ``.npz``
    file in a fresh call: the same kernels in the same order, so the final
    state must equal the straight run's bit for bit, and each run launches
    K1 and K2 once a tick."""
    import tempfile

    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig, run_fleet_episodes
    from mpc_for_av_at_intersection_tpu_torch.utils.checkpoint import run_chunked

    cfg, world, state, geom = EngineConfig(), fleet["world"], fleet["state"], fleet["geom"]
    want = expected(build_qp=FLEET_T, solve_box_qp_fused=FLEET_T)
    reset_launches()
    straight, _ = run_fleet_episodes(world, state, cfg, geom, FLEET_T)
    torch.cuda.synchronize()
    check(read_launches() == want, f"checkpoint: straight run launches {read_launches()}")

    def step_many(st, n):
        return run_fleet_episodes(world, st, cfg, geom, n)

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/fleet.npz"
        reset_launches()
        mid, tels = run_chunked(step_many, state, CKPT_BREAK, CKPT_CHUNK, ckpt_path=path)
        check(len(tels) == CKPT_BREAK // CKPT_CHUNK and int(mid.tick.max()) == CKPT_BREAK,
              f"checkpoint: {len(tels)} chunks before the break, tick {int(mid.tick.max())}")
        del mid
        final, tels = run_chunked(step_many, state, FLEET_T, CKPT_CHUNK, ckpt_path=path)
        torch.cuda.synchronize()
        launches = read_launches()
        size = os.path.getsize(path)
    check(launches == want, f"checkpoint: chunked launches {launches}, want {want}")
    check(len(tels) == (FLEET_T - CKPT_BREAK) // CKPT_CHUNK,
          f"checkpoint: the resumed run ran {len(tels)} chunks")
    check(_same_tree(final, straight), "checkpoint: the resumed fleet differs from the straight run")
    print(f"checkpoint: {FLEET_B} scenarios x {FLEET_T} ticks in chunks of {CKPT_CHUNK}, broken "
          f"off after {CKPT_BREAK} and resumed from a {size / 2**20:.2f} MiB snapshot: final state "
          f"bit-equal to the straight run; launches {_nonzero(launches)}")
    lap("23 checkpoint")
    return {"launches": launches}


def phase_sweeps_live(dev, smi_line):
    """Phase 24: the sweeps and the live loop. ``sweep.mpc_weight_sweep``
    over w_perp in {1, 5, 20} on the flagship without traffic (64 ticks an
    episode, K1 and K2 once a tick): every value reaches the goal, the max
    deviation does not grow with the weight. ``sweep.planner_weight_sweep``
    on the flagship junction (host search): a heavier distance heuristic
    expands no more. ``engine.run_episode_live`` on the flagship with its
    traffic for 40 ticks, its callback writing each tick's host arrays to
    a frame file (``LiveView`` draws with matplotlib, which the card's
    machine lacks; ``tests/test_torch_live_viz.py`` holds it on the CPU):
    its telemetry equals ``run_episode``'s bit for bit, 40 frames written."""
    import tempfile

    from mpc_for_av_at_intersection_tpu_torch import api, sweep
    from mpc_for_av_at_intersection_tpu_torch.engine import run_episode, run_episode_live
    from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map
    from mpc_for_av_at_intersection_tpu_torch.lattice import SearchWeights
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

    n = len(SWEEP_VALUES) * SWEEP_STEPS
    reset_launches()
    t0 = time.perf_counter()
    recs = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg, n_steps=SWEEP_STEPS,
                                           device=dev),
        "w_perp", SWEEP_VALUES, n_steps=SWEEP_STEPS)
    sweep_s = time.perf_counter() - t0
    sweep_launches = read_launches()
    check(sweep_launches == expected(build_qp=n, solve_box_qp_fused=n),
          f"mpc sweep launches {sweep_launches}")
    check(all(r.done for r in recs), f"mpc sweep: not done at {[r.value for r in recs]}")
    devs = [r.max_deviation for r in recs]
    check(all(b <= a for a, b in zip(devs, devs[1:])), f"mpc sweep: max deviation {devs}")

    geom = bicycle_geometry()
    plans = sweep.planner_weight_sweep(intersection(turn_indicator=1, start_pos=4), geom,
                                       {"h_dist": [1.0, 2.0]}, base=SearchWeights.modified())
    check(all(r.cost > 0 and len(r.trajectory) > 100 for r in plans)
          and plans[1].n_expanded <= plans[0].n_expanded,
          f"planner sweep: {[(r.cost, r.n_expanded) for r in plans]}")

    setup = api.build_intersection(n_steps=LIVE_STEPS, device=dev)
    reset_launches()
    _, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, LIVE_STEPS)
    tel = tree_map(lambda t: t.cpu().numpy(), tel)
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        def record(k, st, tel_k, agents6):
            np.savez(f"{tmp}/frame_{k:04d}.npz", ego=st.ego, agents6=agents6,
                     **tel_k._asdict())

        t0 = time.perf_counter()
        final, tel_l = run_episode_live(setup.world, setup.state0, setup.cfg, setup.geom,
                                        LIVE_STEPS, on_tick=record)
        live_ms = (time.perf_counter() - t0) * 1e3 / len(tel_l.x)
        live_launches = read_launches()
        frames = len(list(Path(tmp).glob("frame_*.npz")))
    ran = len(tel_l.x)
    check(ran == LIVE_STEPS and frames == LIVE_STEPS, f"live loop: {ran} ticks, {frames} frames")
    check(live_launches == expected(build_qp=ran, solve_box_qp_fused=ran),
          f"live loop launches {live_launches}")
    for name in tel_l._fields:
        check(np.array_equal(getattr(tel_l, name), getattr(tel, name)[:ran]),
              f"live loop: telemetry {name} differs from run_episode's")
    print(f"sweeps: w_perp {list(SWEEP_VALUES)} done at {[r.ticks_to_goal for r in recs]}, max "
          f"deviation {[round(d, 4) for d in devs]} m, {n} ticks in {sweep_s:.1f} s, launches "
          f"{_nonzero(sweep_launches)}; planner h_dist [1, 2]: cost "
          f"{[round(r.cost, 3) for r in plans]}, expansions {[r.n_expanded for r in plans]}; "
          f"live loop: {ran} ticks equal to run_episode's bit for bit, {frames} frames, "
          f"{live_ms:.2f} ms per tick with the callback, launches {_nonzero(live_launches)} "
          f"[{smi_line}]")
    lap("24 sweeps and live loop")
    return {"sweep_launches": sweep_launches, "live_launches": live_launches}


# A CLI subprocess that counts the kernels it launched: runs the module
# named by its first argument as ``python -m`` would, then prints the
# wrappers' counts on stderr
_COUNTED = r"""
import json, runpy, sys
from chip_smoke import read_launches
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps(read_launches()), file=sys.stderr, flush=True)
"""
PKG = "mpc_for_av_at_intersection_tpu_torch"


def _start(args, counted=True):
    cmd = [sys.executable, "-c", _COUNTED] + args if counted else [sys.executable, "-m"] + args
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)


def _finish(tag, proc):
    """Wait for a CLI subprocess; its JSON (the last JSON value on stdout),
    its launch counts and its stderr. A failure or a timeout fails the
    phase."""
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"chip_smoke: CLI {tag}: no end within {CLI_TIMEOUT} s")
    check(proc.returncode == 0, f"CLI {tag}: exit {proc.returncode}\n{err[-3000:]}")
    lines = [ln for ln in err.splitlines() if ln.startswith("LAUNCHES ")]
    launches = json.loads(lines[-1][len("LAUNCHES "):]) if lines else None
    text = out.strip()
    start = max(text.rfind("\n{"), text.rfind("\n["))
    return json.loads(text[start + 1:] if start >= 0 else text), launches, err


def phase_cli(dev, smi_line, kind):
    """Phase 25: the CLI, each command a subprocess of its own that reuses
    the kernel library built in phase 2 (no file of the build directory is
    added). ``run --driver intersection`` (done, no unsolved tick),
    ``plan`` (through ``python -m``), ``fleet --n 1024 --steps 32
    --planner device`` (K3 once, K1 and K2 once a tick), ``sweep --steps
    64`` (every value done, deviation not growing with the weight), the
    fleet worker as one NCCL rank (its summary equal to ``run_batch_episodes``
    without a mesh on the same fleet here) and ``fleet --shard`` under
    torchrun as one NCCL rank (the unsharded ``fleet``'s summary) run side
    by side; then ``bench``
    alone (both metric names; the card's name and power limit and the seed
    on stderr). Every counted command launches K1 and K2 exactly as often
    as it ran ticks."""
    import socket

    from mpc_for_av_at_intersection_tpu_torch import bench as pbench
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.ops import _build
    from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes
    from mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker import build_demo_fleet

    built = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    per_tick = max(EngineConfig().mpc.max_iter, 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = {
        "run": _start([PKG, "run", "--driver", "intersection"]),
        "plan": _start([PKG, "plan"], counted=False),
        "fleet": _start([PKG, "fleet", "--n", str(FLEET_B), "--steps", str(FLEET_T),
                         "--planner", "device"]),
        "sweep": _start([PKG, "sweep", "--steps", str(SWEEP_STEPS)]),
        "fleet_worker": _start([f"{PKG}.parallel.fleet_worker", "--coordinator",
                                f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0",
                                "--batch", "8", "--steps", "3"]),
        # "--" ends torchrun's options: its argparse can read --n as an
        # abbreviation of its own (Python 3.12.3)
        "fleet --shard": _start(["torch.distributed.run", "--standalone", "--nproc-per-node=1",
                                 "-m", PKG, "--", "fleet", "--n", str(FLEET_B), "--steps",
                                 str(FLEET_T), "--planner", "device", "--shard"], counted=False),
    }
    res = {tag: _finish(tag, p) for tag, p in procs.items()}
    side_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["bench"] = _finish("bench", _start([PKG, "bench"]))
    bench_s = time.perf_counter() - t0

    run, run_l, _ = res["run"]
    check(run["done"] and run["unsolved_ticks"] == 0, f"CLI run: {run}")
    bench_tick = max(MPCConfig(T=pbench.HORIZON).max_iter, 1)
    want = {"run": 256 * per_tick, "fleet": FLEET_T * per_tick,
            "sweep": 3 * SWEEP_STEPS * per_tick, "fleet_worker": 3 * per_tick,
            "bench": (1 + pbench.STEADY_ITERS) * bench_tick
            + 2 * pbench.FLEET_STEPS * per_tick}
    for tag, n in want.items():
        got = res[tag][1]
        k3 = 1 if tag == "fleet" else 0
        check(got == expected(build_qp=n, solve_box_qp_fused=n, astar_search=k3),
              f"CLI {tag}: launches {got}, want K1 = K2 = {n}, K3 {k3}")
    plan = res["plan"][0]
    check(plan["cost"] > 0 and plan["backend"] == "native", f"CLI plan: {plan}")
    fleet = res["fleet"][0]
    check(fleet["n_scenarios"] == FLEET_B and fleet["devices"] == 1
          and fleet["unsolved_ticks"] <= 0.02 * FLEET_B * FLEET_T, f"CLI fleet: {fleet}")
    shard = res["fleet --shard"][0]
    check(shard["devices"] == 1 and all(shard[k] == fleet[k] for k in (
        "n_scenarios", "n_done", "unsolved_ticks", "mean_ticks_to_goal")),
        f"CLI fleet --shard under torchrun (NCCL): {shard}, unsharded {fleet}")
    sweep = res["sweep"][0]
    devs = [r["max_deviation"] for r in sweep]
    check(all(r["done"] for r in sweep) and all(b <= a for a, b in zip(devs, devs[1:])),
          f"CLI sweep: {sweep}")
    worker = res["fleet_worker"][0]
    cfg, geom, wb, sb = build_demo_fleet(8, 3, device=dev)
    _, _, summary = run_batch_episodes(wb, sb, cfg, geom, 3)
    summary = {k: int(v) for k, v in summary.items()}
    check({k: worker[k] for k in summary} == summary and worker["device"] == kind
          and worker["mesh"] == {"hosts": 1, "chips": 1},
          f"CLI fleet worker (NCCL): {worker}, without a mesh {summary}")
    bench, _, bench_err = res["bench"]
    check({"mpc_solves_per_sec_per_chip_T20", "fleet_scenario_ticks_per_s"}
          <= {bench.get("metric"), *bench}, f"CLI bench: {bench}")
    check(smi_line in bench_err and "seed=" in bench_err and "# batch=" in bench_err,
          f"CLI bench stderr: {bench_err[-500:]}")
    now = sorted(p.name for p in _build.BUILD_DIR.iterdir())
    check(now == built, f"CLI: the build directory changed: {sorted(set(now) - set(built))}")
    print(f"CLI: run done at tick {run['ticks_to_goal']} in {run['wall_seconds']} s; plan cost "
          f"{plan['cost']}, {plan['expansions']} expansions; fleet {fleet}; sweep "
          f"{[(r['value'], r['ticks_to_goal'], r['max_deviation']) for r in sweep]}; NCCL fleet "
          f"worker {worker}; fleet --shard under torchrun (one NCCL rank) {shard}; six side by "
          f"side {side_s:.1f} s; bench {bench} in {bench_s:.1f} s "
          f"({next(ln for ln in bench_err.splitlines() if ln.startswith('# batch='))}); launches "
          + ", ".join(f"{t} {_nonzero(res[t][1])}" for t in want) + f" [{smi_line}]")
    lap("25 CLI")
    return {name: {tag: res[tag][1][name] for tag in want if res[tag][1][name]}
            for name in ("build_qp", "solve_box_qp_fused", "astar_search")}


def kernel_wrappers():
    """Every kernel wrapper of the port, by name; each counts its launches."""
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
        admm_all_rounds,
        admm_iterations,
        admm_round_full,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    return {"build_qp": build_qp, "solve_box_qp_fused": solve_box_qp_fused,
            "ruiz_admm_all_rounds": ruiz_admm_all_rounds, "polish_select": polish_select,
            "astar_search": astar_search_batch, "admm_iterations": admm_iterations,
            "admm_round_full": admm_round_full, "admm_all_rounds": admm_all_rounds}


# wrappers whose kernel also has a cluster instantiation (a scenario on 2-4
# CTAs past one CTA's shared memory); their launches on a cluster are
# counted apart too, as "<name>_cluster"
CLUSTER_WRAPPERS = ("solve_box_qp_fused", "ruiz_admm_all_rounds", "polish_select")


def reset_launches():
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for k in CLUSTER_WRAPPERS:
        wrappers[k].cluster_launches = 0


def read_launches():
    wrappers = kernel_wrappers()
    out = {k: w.launches for k, w in wrappers.items()}
    out.update({f"{k}_cluster": getattr(wrappers[k], "cluster_launches", 0)
                for k in CLUSTER_WRAPPERS})
    return out


def expected(**counts):
    """The launch counts of a path: the kernels named, and no other."""
    return {k: counts.get(k, 0) for k in read_launches()}


def solver_kw(cfg):
    """The solve's keyword arguments under ``cfg``'s schedule."""
    checks, iters, eps, band, cap, ratio = cfg.solver_schedule
    return dict(rounds=checks, iters=iters, rho0=cfg.admm_rho, sigma=cfg.admm_sigma,
                alpha=cfg.admm_alpha, eps=eps, refactor_band=band, stall_cap=cap,
                stall_ratio=ratio, ruiz_iters=cfg.admm_ruiz_iters)


def tick_loop(tag, cfg, inputs, want, p95_gate=True, long_horizon=False):
    """1 cold + N_WARM warm closed-loop ticks of ``mpc_step_batched`` under
    ``cfg`` at the headline size, launch counts reset just before and read
    just after (they must equal ``want``), every tick solving >= 98%. Ticks
    0 and N_WARM are then re-run from the carried state on the CPU plain
    path, and the warm tick is timed against the plain path on the card.
    ``long_horizon`` (phase 26, where the algorithm itself may solve fewer
    than 98% of the rows): a tick under 98% is held to the plain tick on
    the card from the same state instead (``plain_share_bar``), and so is
    the count of rows both paths solve on the re-run (against the float32
    plain path's); every row of ticks 0 and N_WARM is re-run, on the card,
    instead of CPU_ROWS rows on the CPU; the p99 of the error is printed,
    not gated (see phase 26).

    The kernel path's controls are held to the float64 CPU tick with phase
    5's bars (error quantiles p50/p90/p99 at most 1.5x the float32 plain
    path's + 1e-5) and phase 6's tail bar (below). ``p95_gate`` adds phase
    6's bar against the float32 plain path (p95 < 2e-3), which holds where
    float32 fixes the first control: the canonical, polished tick. Without
    it (reported, not gated): the jerk tick's commanded accel u0_0 lies on
    its QP's least-determined direction (the split between u0_0 and the
    free initial accel a0, weighted only by r_accel and the dt^2 jerk
    penalty), and the unpolished tick returns an ADMM iterate stopped at a
    1e-4 relative residual; there two float32 solvers differ by more than
    2e-3 on several percent of rows, the kernel path no farther from the
    float64 tick than the float32 plain path."""
    from mpc_for_av_at_intersection_tpu_torch.core import SimLimits, plant_step
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import (
        controller_state_from_numpy,
        controller_state_to_numpy,
        init_controller_state,
    )
    from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp_reference

    states0, courses, speeds, valid, dls = inputs
    f32 = torch.float32
    wheelbase = bicycle_geometry().wheelbase
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    states = states0
    cs = init_controller_state(cfg, device=states0.device, batch=B)
    ref = states0.device if long_horizon else torch.device("cpu")
    rows = B if long_horizon else CPU_ROWS
    gated = (50, 90) if long_horizon else (50, 90, 99)
    snap, outs, tick_ms, shares, plain_shares = {}, {}, [], [], {}
    reset_launches()
    for tick in range(1 + N_WARM):
        if tick in (0, N_WARM):
            snap[tick] = (states[:rows].cpu(),
                          {k: v[:rows] for k, v in controller_state_to_numpy(cs).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_step_batched(states, courses, speeds, valid, dls, cs, cfg, wheelbase)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        shares.append(float(out.solved.float().mean()))
        bar = 0.98
        if long_horizon and shares[-1] < bar:
            plain = _mpc_step(states, courses, speeds, valid, dls, cs, cfg, wheelbase,
                              build_qp_reference, solve_box_qp_batched)
            plain_shares[tick] = float(plain.solved.float().mean())
            bar = plain_share_bar(plain_shares[tick], B)
        check(shares[-1] >= bar, f"{tag}, tick {tick}: solved share {shares[-1]} < {bar}")
        if tick in (0, N_WARM):
            outs[tick] = out
        states = plant_step(states, torch.stack([out.accel, out.steer], dim=-1), cfg.dt,
                            wheelbase, limits)
        cs = out.state
    launches = read_launches()
    check(launches == want, f"{tag}: kernel launches over the loop {launches}, want {want}")
    check(bool(states.isfinite().all()), f"{tag}: plant states went non-finite")
    held = (f"; ticks under 98% held to the plain tick's share on the card: "
            + ", ".join(f"tick {k} {shares[k]:.4f} (plain {v:.4f})"
                        for k, v in plain_shares.items())) if plain_shares else ""
    print(f"{tag}: {1 + N_WARM} ticks, launches {launches}, solved share min "
          f"{min(shares):.4f}, cold tick {tick_ms[0]:.1f} ms{held}")

    # The same rows on CPU tensors from the carried state: the plain path in
    # float32, and in float64 as the yardstick for the tail. The p95
    # bar of tests/test_batched_solver.py:361 (2e-3) holds against the
    # float32 plain path. Its max bar (2e-2) does not hold for float32 at
    # all on a cold tick: the float32 plain path itself is off the float64
    # tick by up to ~2 on a few rows (near-flat QP directions, see
    # compare_solutions). So the tail bar counts rows off the float64 tick
    # by > 2e-2: the kernel path may have no more of them than the float32
    # plain path, plus max(2, 1% of the rows).
    sl = slice(0, rows)
    for tick, (st_cpu, cs_np) in snap.items():
        o = outs[tick]
        plain = {}
        for dt in (f32, torch.float64):
            cs_ref = controller_state_from_numpy(cs_np, ref)
            cs_ref = cs_ref._replace(**{k: v.to(dt) for k, v in cs_ref._asdict().items()
                                        if v.is_floating_point()})
            plain[dt] = _mpc_step(st_cpu.to(ref, dt), courses[sl].to(ref, dt),
                                  speeds[sl].to(ref, dt), valid[sl].to(ref),
                                  dls[sl].to(ref, dt), cs_ref, cfg, wheelbase,
                                  build_qp_reference, solve_box_qp_batched)
        p32, p64 = plain[f32], plain[torch.float64]
        both = o.solved[sl].cpu() & p32.solved.cpu()
        d32 = (controls(o, sl) - controls(p32)).abs()[both]
        p95 = float(d32.quantile(0.95, dim=0).max())
        mx = float(d32.max())
        all3 = both & p64.solved.cpu()
        ek = (controls(o, sl) - controls(p64)).abs().amax(1)[all3]
        ep = (controls(p32) - controls(p64)).abs().amax(1)[all3]
        qk, qp_ = quantiles(ek), quantiles(ep)
        tail_k, tail_p = int((ek > 2e-2).sum()), int((ep > 2e-2).sum())
        idx_eq = bool((o.target_idx[sl].cpu() == p32.target_idx.cpu()).all())
        print(f"{tag}, tick {tick} vs plain on the {ref.type} ({rows} rows, {int(both.sum())} both "
              f"solved): controls p95 {p95:.3g} ({'bar 2e-3' if p95_gate else 'not gated'}), "
              f"max {mx:.3g}; error vs the float64 tick (gated p{'/p'.join(map(str, gated))}) "
              f"p50/p90/p99 kernel path "
              f"{qk[0]:.3g}/{qk[1]:.3g}/{qk[2]:.3g}, float32 plain {qp_[0]:.3g}/{qp_[1]:.3g}/"
              f"{qp_[2]:.3g}; rows off it by > 2e-2: kernel path {tail_k}, float32 plain "
              f"{tail_p}; target_idx equal {idx_eq}")
        check(idx_eq, f"{tag}, tick {tick}: target_idx differs from the plain path")
        need = 0.98 * rows
        if long_horizon:
            need = rows * plain_share_bar(float(p32.solved.float().mean()), rows)
        check(int(both.sum()) >= need, f"{tag}, tick {tick}: {int(both.sum())} rows solved by "
              f"both < {need}")
        if p95_gate:
            check(p95 < 2e-3, f"{tag}, tick {tick}: controls p95 {p95}")
        for q, a, b in zip((50, 90, 99), qk, qp_):
            check(a <= 1.5 * b + 1e-5 or q not in gated,
                  f"{tag}, tick {tick}: p{q} error vs the float64 tick {a} > 1.5 x plain {b}")
        check(tail_k <= tail_p + max(2, rows // 100),
              f"{tag}, tick {tick}: {tail_k} rows off the float64 tick, float32 plain {tail_p}")

    # warm-tick time, kernel path vs plain path on the card, same state
    args = (states, courses, speeds, valid, dls, cs, cfg, wheelbase)
    loop_ms = float(np.median(tick_ms[1:]))
    kern_ms = float(np.median([_timed(lambda: mpc_step_batched(*args)) for _ in range(5)]))
    plain_ms = float(np.median([
        _timed(lambda: _mpc_step(*args, build_qp_reference, solve_box_qp_batched))
        for _ in range(3)]))
    print(f"{tag}, warm tick: kernel path {loop_ms:.2f} ms median over the loop "
          f"({B / loop_ms * 1e3:.0f} solves/s), {kern_ms:.2f} ms on the final state; "
          f"plain path {plain_ms:.2f} ms ({B / plain_ms * 1e3:.0f} solves/s)")
    lap(tag)
    return {"launches": launches, "loop_ms": loop_ms, "min_share": min(shares),
            "plain_shares": plain_shares, "plain_ms": plain_ms}


def warm_tick_ms(cfg, inputs):
    """Median host-clock time of the N_WARM warm ticks after a cold one of
    ``mpc_step_batched`` under ``cfg``, closed loop as ``tick_loop`` runs it
    (each tick bracketed by ``torch.cuda.synchronize()``), with no checks."""
    from mpc_for_av_at_intersection_tpu_torch.core import SimLimits, plant_step
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.mpc.batch import mpc_step_batched

    states, courses, speeds, valid, dls = inputs
    wheelbase = bicycle_geometry().wheelbase
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    cs = init_controller_state(cfg, device=states.device, batch=B)
    tick_ms = []
    for _ in range(1 + N_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_step_batched(states, courses, speeds, valid, dls, cs, cfg, wheelbase)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        states = plant_step(states, torch.stack([out.accel, out.steer], dim=-1), cfg.dt,
                            wheelbase, limits)
        cs = out.state
    return float(np.median(tick_ms[1:]))


def same_bits(a, b):
    """Equal shape, dtype and bits (NaNs and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_two_launch(qp, kw, warm, cold_k, warm_k, x_true, cert):
    """Phase 13: the two-launch twin of K2 (A/B-1, then A/B-2) on the
    headline tick's cold and warm QPs (phase 5's), bit for bit against K2;
    A/B-1 and A/B-2 each against their plain versions, and timed beside K2."""
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import polish_and_select, ruiz_admm_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp,
        solve_box_qp_fused,
    )

    # ---- the main path: the two-launch solve, counted ----
    reset_launches()
    twin_cold = solve_box_qp(*qp, fused=False, **kw)
    twin_warm = solve_box_qp(*qp, fused=False, warm=warm, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(ruiz_admm_all_rounds=2, polish_select=2),
          f"two-launch solve: launches {launches}")
    for tag, a, b in (("cold", twin_cold, cold_k), ("warm", twin_warm, warm_k)):
        differ = [f for f in a._fields if not same_bits(getattr(a, f), getattr(b, f))]
        check(not differ, f"two-launch solve {tag}: differs from K2 in {differ}")
    print(f"two-launch solve (A/B-1 then A/B-2): bit-identical to K2 in x, y, polished, "
          f"prim_res, dual_res, rho and checks, cold and warm; launches {launches}")

    # ---- A/B-1 against its plain version, cold and warm ----
    ab1_err = 0.0
    for tag, w in (("cold", None), ("warm", warm)):
        kern = ruiz_admm_all_rounds(*qp, warm=w, **kw)
        plain = ruiz_admm_batched(*qp, warm=w, **kw)
        compare_solutions(kern, plain, x_true, cert, f"A/B-1 {tag}")
        ab1_err = max(ab1_err, float((kern.x - plain.x).abs().max()))
        dp = (kern.prim_res - plain.prim_res).abs()
        print(f"A/B-1 {tag}: max|dx| {float((kern.x - plain.x).abs().max()):.3g} over all rows; "
              f"scaled prim_res p50 kernel {float(kern.prim_res.median()):.3g} plain "
              f"{float(plain.prim_res.median()):.3g}, max|d| {float(dp.max()):.3g}")
    ab1 = kern   # warm

    # ---- A/B-2 against its plain version, on the same ADMM solution: held
    # as K2 is (compare_solutions); the acceptance test's float32 margins
    # (violation <= 1e-5 span, objective) decide a few percent of the rows
    # differently, as they do between K2 and its plain version ----
    pk = polish_select(*qp, ab1)
    pp = polish_and_select(*qp, ab1)
    ab2_err = compare_solutions(pk, pp, x_true, cert, "A/B-2 warm")
    print(f"A/B-2 warm: polish accepted kernel {int(pk.polished.sum())} plain "
          f"{int(pp.polished.sum())}, flags differ on {int((pk.polished != pp.polished).sum())} "
          f"rows; max|dx| where both accepted {ab2_err:.3g}")

    # ---- times, K2 beside the pair (K2, A/B-1, A/B-2, K2) ----
    k2_a = cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 10)
    ab1_ms = cuda_ms(lambda: ruiz_admm_all_rounds(*qp, warm=warm, **kw), 10)
    ab2_ms = cuda_ms(lambda: polish_select(*qp, ab1), 10)
    k2_b = cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 10)
    ab1_plain_ms = cuda_ms(lambda: ruiz_admm_batched(*qp, warm=warm, **kw), 3)
    ab2_plain_ms = cuda_ms(lambda: polish_and_select(*qp, ab1), 3)
    iters = kw["iters"]
    ab1_bound_ms, ab1_bound_by = solve_bound(qp, ab1, iters, kw["ruiz_iters"], True, polish=False)
    ab2_bound_ms, ab2_bound_by = solve_bound(qp, pk, iters, kw["ruiz_iters"], True, admm=False)
    n, m = qp[1].shape[1], qp[3].shape[1]
    occ = admm_bucket_report(("K2", "A/B-1", "A/B-2"))
    print(f"two-launch time (warm, n={n}, m={m}): A/B-1 {ab1_ms:.3f} ms (plain "
          f"{ab1_plain_ms:.3f}, bound {ab1_bound_ms:.4f} {ab1_bound_by}) + A/B-2 {ab2_ms:.3f} ms "
          f"(plain {ab2_plain_ms:.3f}, bound {ab2_bound_ms:.4f} {ab2_bound_by}) = "
          f"{ab1_ms + ab2_ms:.3f} ms against K2 {k2_a:.3f} / {k2_b:.3f} ms "
          f"({(ab1_ms + ab2_ms) / (0.5 * (k2_a + k2_b)) - 1:+.1%}); {occ}; A/B-2's "
          f"active rows a p50/p90/p99/max {active_rows(pk)}")
    lap("13 two-launch solve")
    return {"launches": launches, "ab1_err": ab1_err, "ab1_ms": ab1_ms,
            "ab1_plain_ms": ab1_plain_ms, "ab1_bound_ms": ab1_bound_ms,
            "ab1_bound_by": ab1_bound_by, "ab2_err": ab2_err, "ab2_ms": ab2_ms,
            "ab2_plain_ms": ab2_plain_ms, "ab2_bound_ms": ab2_bound_ms,
            "ab2_bound_by": ab2_bound_by}


def phase_jerk_qp(states0, oa, od, ref):
    """Phase 14: K1's jerk mode against its plain version on the headline
    tick's inputs (n = 2T+1 = 41), and K2 at that odd n against its plain
    version and the float64 optimum, cold."""
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

    cfg = dataclasses.replace(MPCConfig.with_jerk(), T=T)
    args = (states0, oa, od, ref.xref, ref.reaches_end, cfg, bicycle_geometry().wheelbase)
    qp_k = build_qp(*args)
    qp_p = build_qp_reference(*args)
    torch.cuda.synchronize()
    err, rel = 0.0, {}
    for name in qp_p._fields:
        a, b = getattr(qp_p, name), getattr(qp_k, name)
        check(a.shape == b.shape, f"K1 jerk field {name}: shape {tuple(b.shape)}, plain {tuple(a.shape)}")
        e = float((a - b).abs().max())
        scale = max(1.0, float(a.abs().max()))
        err = max(err, e)
        rel[name] = e / scale
        check(e <= 1e-5 * scale, f"K1 jerk field {name}: error {e} > 1e-5 * {scale}")
    k1_ms = cuda_ms(lambda: build_qp(*args), 20)
    k1_plain_ms = cuda_ms(lambda: build_qp_reference(*args), 5)
    bound_ms, bound_by = k1_bound(B, T, jerk=True)
    print(f"K1 jerk (n={qp_k.q.shape[1]}, F {tuple(qp_k.F.shape[1:])}) vs plain, "
          "max|err|/max(1,|ref|): " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (bar 1e-5); kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {k1_kernel_report(T, jerk=True)}")

    kw = solver_kw(cfg)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    x_true, cert = true_solution(qp)
    compare_solutions(solve_box_qp_fused(*qp, **kw), solve_box_qp_batched(*qp, **kw), x_true,
                      cert, f"K2 jerk n={qp_k.q.shape[1]} cold")
    lap("14 K1 jerk, K2 at odd n")
    return {"k1_err": err, "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_bound_ms": bound_ms,
            "k1_bound_by": bound_by}


def phase_jerk_fleet(dev, fleet):
    """Phase 17: phase 9's fleet (same worlds, cold controllers) under the
    jerk controller, 1024 scenarios x 32 ticks, held against the CPU plain
    path."""
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes

    cfg = EngineConfig(mpc=MPCConfig.with_jerk())
    world, geom = fleet["world"], fleet["geom"]
    state = fleet["state"]._replace(ctrl=init_controller_state(cfg.mpc, device=dev,
                                                                batch=FLEET_B))
    reset_launches()
    final, tel, summary = run_batch_episodes(world, state, cfg, geom, FLEET_T)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(build_qp=FLEET_T, solve_box_qp_fused=FLEET_T),
          f"jerk fleet launches {launches}")
    live = ~tel.done
    shares = [float(tel.solved[live[:, t], t].float().mean()) if bool(live[:, t].any()) else 1.0
              for t in range(FLEET_T)]
    check(min(shares) >= 0.98, f"jerk fleet: solved share over live rows {min(shares)}")
    check(bool(final.ego.isfinite().all()) and bool(tel.x.isfinite().all())
          and bool(tel.steer.isfinite().all()), "jerk fleet: states went non-finite")
    t0 = time.perf_counter()
    _, _, summary2 = run_batch_episodes(world, state, cfg, geom, FLEET_T)
    int(summary2["n_done"])
    run_s = time.perf_counter() - t0
    print(f"jerk fleet: {FLEET_B} scenarios x {FLEET_T} ticks, T={cfg.mpc.T} (n="
          f"{cfg.mpc.qp_dims[0]}); launches {launches}; solved share over live rows min "
          f"{min(shares):.4f}; done {int(summary['n_done'])}, unsolved ticks "
          f"{int(summary['n_unsolved_ticks'])}; {FLEET_B * FLEET_T / run_s:.1f} scenario "
          f"ticks/s ({run_s * 1e3 / FLEET_T:.2f} ms per tick)")
    compare_with_cpu_plain("jerk fleet", world, state, cfg, geom, FLEET_T - 1)
    lap("17 jerk fleet")
    return {"launches": launches}



def random_qps(B, n, m, seed, dev):
    """The random box-QPs of tests/test_batched_solver.py:15-24 (float32):
    (P, q, G, lo, hi)."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", Z, Z) + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n))
    center = rng.normal(size=(B, m))
    width = rng.uniform(0.1, 2.0, size=(B, m))
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (P, q, G, center - width, center + width))


def probe_bound(name, B, n, m, iters, rounds):
    """(ms, "bytes"|"operations") for a probe at this shape, running
    ``rounds`` factorized rounds (Probe-1 one, Probe-3 none) of ``iters``
    iterations: inputs read once (Probe-3 reads M^-1 where Probe-1/2 read
    P), outputs written once (x, z, y; Probe-1 also prim, dual and four
    scales, Probe-2 prim and dual). Operations: per iteration the JAX
    profiler's count 2(n^2 + 2mn) + 8(n + m); for Probe-1/2 also G'G once
    (its lower triangle, m n (n+1) flops), and per round M (n^2), the
    Cholesky factor, L^-1 and Y'Y (n^3/3 flops each) and the residuals
    (2n^2 + 4mn + 4(n + m))."""
    it_flops = 2 * (n * n + 2 * m * n) + 8 * (n + m)
    n_out = {"admm_iterations": 0, "admm_round_full": 6, "admm_all_rounds": 2}[name]
    nbytes = B * 4 * (n * n + m * n + 3 * n + 6 * m + 1 + n_out)
    if name == "admm_iterations":
        flops = iters * it_flops
    else:
        per_round = n * n + n ** 3 + iters * it_flops + 2 * n * n + 4 * m * n + 4 * (n + m)
        flops = m * n * (n + 1) + rounds * per_round
    return _bound(nbytes, B * flops)


def _absmax(t):
    """max|t|, 0 for an empty tensor."""
    return float(t.abs().max()) if t.numel() else 0.0


def _probe_outputs(out):
    """A probe's result as a flat list of tensors."""
    return [v for e in out for v in (e if isinstance(e, tuple) else (e,))]


def probe_functions():
    """{name: (kernel wrapper, plain version)} of the three probes."""
    from mpc_for_av_at_intersection_tpu_torch.ops import admm_probes as ap

    return {"admm_iterations": (ap.admm_iterations, ap.admm_iterations_reference),
            "admm_round_full": (ap.admm_round_full, ap.admm_round_full_reference),
            "admm_all_rounds": (ap.admm_all_rounds, ap.admm_all_rounds_reference)}


def probe_inputs(qp, cfg, dtype=torch.float32):
    """Each probe's positional arguments on the box-QP ``qp`` = (P, q, G,
    lo, hi), cold (x = z = y = 0), rho = ``cfg.admm_rho``, the iteration
    counts of ``cfg`` (``admm_rounds`` x ``admm_iters``). Probe-3 takes
    M^-1 of M = P + sigma I + rho G'G, inverted in float64."""
    P, q, G, lo, hi = qp
    B, n = q.shape
    m = lo.shape[1]
    dev = q.device
    rho0, sigma = cfg.admm_rho, cfg.admm_sigma
    rho = torch.full((B,), rho0, dtype=dtype, device=dev)
    M = (P.double() + sigma * torch.eye(n, dtype=torch.float64, device=dev)
         + rho0 * (G.double().transpose(1, 2) @ G.double()))
    rest = tuple(a.to(dtype) for a in (G, q, lo, hi)) + (rho,)
    cold = tuple(torch.zeros((B, k), dtype=dtype, device=dev) for k in (n, m, m))
    tail = (cfg.admm_sigma, cfg.admm_alpha)
    iters = (cfg.admm_iters,)
    Minv = torch.linalg.inv(M).to(dtype).contiguous()
    return {"admm_iterations": ((Minv,) + rest, cold, iters + tail),
            "admm_round_full": ((P.to(dtype),) + rest, cold, iters + tail),
            "admm_all_rounds": ((P.to(dtype),) + rest, cold, (cfg.admm_rounds,) + iters + tail)}


PROBE_OUTPUTS = ("x", "z", "y", "prim", "dual", "max|Gx|", "max|z|", "max|Px|", "max|q|")


def own_residuals_ratio(P, G, q, got):
    """A probe's residual outputs (``got[3:]``: prim, dual and, for
    Probe-1, the four scales) against the float64 residuals of its own
    returned x, z, y: the same formulas on the same iterate, so only the
    kernel's float32 sums part them. Each row's bar is 1e-5 x max(1, the
    largest sum of |terms| in any of its residuals), about 10x a float32
    sum's worst-case error at n + m <= 15. Returns max(error / bar)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import _residuals

    P, G, q, x, z, y = (t.double() for t in (P, G, q, *got[:3]))
    want = _probe_outputs(_residuals(P, G, q, x, z, y))
    aG = G.abs()
    terms = torch.cat([torch.einsum("bij,bj->bi", aG, x.abs()), z.abs(),
                       torch.einsum("bij,bj->bi", P.abs(), x.abs()) + q.abs()
                       + torch.einsum("bji,bj->bi", aG, y.abs())], 1)
    bar = 1e-5 * terms.amax(1).clamp(min=1.0)
    return max(float(((g.double() - w).abs() / bar).max()) for g, w in zip(got[3:], want))


def probes_vs_plain(qp, cfg, tag):
    """Each probe kernel against its plain version on ``qp``, cold and warm
    (from the plain version's own cold output), elementwise, every output.

    Probe-3 and Probe-1 (one round at a fixed rho): x, z, y and Probe-1's
    four scales within 1e-4 x max(1, max|plain|), prim and dual within
    1e-4 x max(1, max|y|) (a residual subtracts G'y and Gx from terms as
    large as y and z, so its float32 error scales with them), the bars of
    tests/test_torch_admm_probes.py against the JAX kernels.

    Probe-2 (three rounds, the OSQP rho rule between them): on rows whose
    box-QP is infeasible the rule drives rho to its bounds and two float32
    runs part, so only the rows that converge (prim and dual <= 1e-3) are
    compared, and the converged sets may differ on B/64 rows. On rows
    converged on both: x and z within 1e-3 x max(1, max|plain|) (each run
    stops within its 1e-3 residuals, so their iterates may differ by about
    that much), prim and dual within 5e-4 absolute, half the 1e-3 that
    bounds both there. y is not compared there: with m > n at a degenerate
    active set the multipliers are not unique, and the dual residual
    already holds them to the problem.

    Every residual output of Probe-1 and Probe-2 is also held, on every
    row, to the float64 residuals of the kernel's own x, z, y
    (``own_residuals_ratio``).

    Returns (failures, {name: max|kernel - plain| over the outputs held})."""
    failures, err = [], {}
    B = qp[1].shape[0]
    for name, (kern, plain) in probe_functions().items():
        args, start, tail = probe_inputs(qp, cfg)[name]
        err[name] = 0.0
        for warm in ("cold", "warm"):
            a = args + start + tail
            got, ref = _probe_outputs(kern(*a)), _probe_outputs(plain(*a))
            torch.cuda.synchronize()
            rows = torch.ones(B, dtype=torch.bool, device=qp[1].device)
            held, xz_bar, res_bar, extra = tuple(range(len(got))), 1e-4, None, ""
            if name == "admm_all_rounds":
                conv_k = (got[3] <= 1e-3) & (got[4] <= 1e-3)
                conv_p = (ref[3] <= 1e-3) & (ref[4] <= 1e-3)
                rows, held, xz_bar, res_bar = conv_k & conv_p, (0, 1, 3, 4), 1e-3, 5e-4
                n_diff = int((conv_k != conv_p).sum())
                if n_diff > B // 64:
                    failures.append(f"{name} {tag} {warm}: converged rows differ on {n_diff}")
                extra = (f" (y not held); converged {int(conv_p.sum())} of {B} rows plain, "
                         f"flags differ on {n_diff}")
            shown = []
            yscale = max(1.0, _absmax(ref[2][rows]))
            for k in held:
                e = _absmax((got[k] - ref[k])[rows])
                if k in (3, 4):
                    bar = res_bar if res_bar is not None else 1e-4 * yscale
                else:
                    bar = (xz_bar if k < 2 else 1e-4) * max(1.0, _absmax(ref[k][rows]))
                shown.append(f"{PROBE_OUTPUTS[k]} {e:.3g}/{bar:.3g}")
                err[name] = max(err[name], e)
                if not e <= bar:
                    failures.append(f"{name} {tag} {warm}: {PROBE_OUTPUTS[k]} off by {e} > {bar}")
            if len(got) > 3:
                ratio = own_residuals_ratio(qp[0], qp[2], qp[1], got)
                shown.append(f"residuals of its own iterate {ratio:.3g} of the bar")
                if not ratio <= 1.0:
                    failures.append(f"{name} {tag} {warm}: residuals of its own iterate off by "
                                    f"{ratio} x the bar")
            print(f"{name} {tag} {warm}: max|kernel - plain| / bar {', '.join(shown)}{extra}")
            start = tuple(t.contiguous() for t in ref[:3])
    return failures, err


def probes_vs_float64(scaled, cfg, tag):
    """Each probe kernel and its plain version on a Ruiz-scaled condensed
    QP, cold, both held to a float64 run of the plain version: at T=20 the
    condensed Hessian's condition number reaches ~1.5e7, so two correct
    float32 runs of 170-510 iterations need not agree elementwise. The
    kernel's error quantiles of x (p50/p90/p99) may not exceed 1.5x plain's
    + 1e-5 (``compare_solutions``' bar), nor its prim and dual quantiles 2x
    plain's + 1e-6 (Probe-3 returns none: both take the plain residuals of
    their x, z, y). Probe-1 is Probe-2's kernel launched at one round: at
    rounds = 1 the two are bit for bit equal. Returns failures."""
    from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import _residuals

    failures = []
    inputs32, inputs64 = probe_inputs(scaled, cfg), probe_inputs(scaled, cfg, torch.float64)
    for name, (kern, plain) in probe_functions().items():
        args, cold, tail = inputs32[name]
        got = _probe_outputs(kern(*args, *cold, *tail))
        ref = _probe_outputs(plain(*args, *cold, *tail))
        a64 = inputs64[name]
        r64 = _probe_outputs(plain(*a64[0], *a64[1], *a64[2]))
        torch.cuda.synchronize()
        if len(got) < 5:
            got += list(_residuals(scaled[0], scaled[2], scaled[1], *got)[:2])
            ref += list(_residuals(scaled[0], scaled[2], scaled[1], *ref)[:2])
        ek, ep = [quantiles((t[0].double() - r64[0]).abs().amax(1)) for t in (got, ref)]
        for p, u, v in zip((50, 90, 99), ek, ep):
            if not u <= 1.5 * v + 1e-5:
                failures.append(f"{name} {tag}: x p{p} error {u} > 1.5 x plain {v}")
        res = []
        for k, label in ((3, "prim"), (4, "dual")):
            rk, rp = quantiles(got[k]), quantiles(ref[k])
            for p, u, v in zip((50, 90, 99), rk, rp):
                if not u <= 2 * v + 1e-6:
                    failures.append(f"{name} {tag}: {label} p{p} {u} > 2 x plain {v}")
            res.append(f"{label} p50/p90/p99 kernel {rk[0]:.3g}/{rk[1]:.3g}/{rk[2]:.3g} plain "
                       f"{rp[0]:.3g}/{rp[1]:.3g}/{rp[2]:.3g}")
        print(f"{name} {tag}: x error vs float64 p50/p90/p99 kernel {ek[0]:.3g}/{ek[1]:.3g}/"
              f"{ek[2]:.3g}, plain {ep[0]:.3g}/{ep[1]:.3g}/{ep[2]:.3g}; {'; '.join(res)}")
    funcs = probe_functions()
    args, cold, tail = inputs32["admm_round_full"]
    one = funcs["admm_round_full"][0](*args, *cold, *tail)
    allr = funcs["admm_all_rounds"][0](*args, *cold, 1, *tail)
    differ = [k for k, (u, v) in enumerate(zip(one[:5], allr)) if not same_bits(u, v)]
    if differ:
        failures.append(f"{tag}: Probe-1 and Probe-2 at rounds=1 differ in outputs {differ}")
    print(f"{tag}: Probe-1 and Probe-2 at rounds=1 "
          f"{'bit-identical' if not differ else f'differ in {differ}'}")
    return failures


def phase_probes(dev, qp_k, cfg):
    """Phase 18: the three ADMM probes against their plain versions: (a) on
    random box-QPs (B=4096, n=6, m=9) elementwise, cold and warm
    (``probes_vs_plain``); (b) on the headline QP (phase 4's K1 output,
    T=20, n=40, m=79), Ruiz-scaled as the profiler scales it, against a
    float64 plain run, and (c) Probe-1 against Probe-2 at rounds = 1
    (``probes_vs_float64``); each timed (CUDA events) on (b)'s inputs beside
    ``probe_bound``."""
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import _ruiz_equilibrate, scale_qp
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    failures, err = probes_vs_plain(random_qps(PROBE_B, PROBE_N, PROBE_M, SEED, dev), cfg,
                                    f"random QPs B={PROBE_B} n={PROBE_N} m={PROBE_M}")
    scaled = scale_qp(qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi,
                      *_ruiz_equilibrate(qp_k.P, qp_k.q, qp_k.G))
    B, n = scaled[1].shape
    m = scaled[3].shape[1]
    failures += probes_vs_float64(scaled, cfg, f"headline QP B={B} n={n} m={m}")
    out = {}
    for name, (kern, plain) in probe_functions().items():
        args, cold, tail = probe_inputs(scaled, cfg)[name]
        ms = cuda_ms(lambda: kern(*args, *cold, *tail), 10)
        plain_ms = cuda_ms(lambda: plain(*args, *cold, *tail), 3)
        rounds = {"admm_iterations": 0, "admm_round_full": 1, "admm_all_rounds": tail[0]}[name]
        bound_ms, bound_by = probe_bound(name, B, n, m, cfg.admm_iters, rounds)
        out[name] = dict(err=err[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        print(f"{name} at B={B}, n={n}, m={m}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.0f}x the bound")
    ms32 = probe3_ms(scaled, cfg, cfg.admm_check_iters, 10)
    per_cta_us = per_iteration_us(out["admm_iterations"]["ms"], ms32, cfg, B, n, m)
    print(f"Probe-3 at B={B}: {ms32:.3f} ms at {cfg.admm_check_iters} iterations (one check "
          f"block), {out['admm_iterations']['ms']:.3f} ms at {cfg.admm_iters}: "
          f"{per_cta_us:.3f} us per iteration per CTA; "
          f"{admm_bucket_report(('Probe-3', 'Probe-1/2'))}")
    check(not failures, "probes: " + "; ".join(failures))
    lap("18 ADMM probes")
    return out


def probe3_ms(scaled, cfg, iters, reps):
    """CUDA-event median of Probe-3 at ``iters`` iterations on phase 18's
    inputs (``probe_inputs`` of the Ruiz-scaled QP ``scaled``)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import admm_iterations

    args, cold, tail = probe_inputs(scaled, cfg)["admm_iterations"]
    return cuda_ms(lambda: admm_iterations(*args, *cold, iters, *tail[1:]), reps)


def per_iteration_us(ms_full, ms_block, cfg, B, n, m):
    """One iteration's time per CTA in us from Probe-3 at ``cfg.admm_iters``
    and at one check block: the difference per iteration, times the CTAs
    the card runs at once over the B CTAs of the launch."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    resident = (torch.cuda.get_device_properties(0).multi_processor_count
                * _build.load().admm_blocks_per_sm(3, n, m))
    per_it_ms = (ms_full - ms_block) / (cfg.admm_iters - cfg.admm_check_iters)
    return per_it_ms * 1e3 * resident / B


def phase_profile_controller(dev):
    """Phase 19: the controller profiler at the headline size. Every stage
    finite and positive, full_tick's last tick solving >= 98%, and the
    launches exactly those of its stages: each stage runs 1 + reps chains
    of k_steps calls (full_tick K1 + K2, condense_k K1, ruiz_admm A/B-1 and
    k_steps more for the check histograms, polish A/B-2, solver_total K2,
    admm_1round Probe-3, round_full Probe-1, admm_all Probe-2), and one K1
    builds ruiz_admm's QP."""
    from mpc_for_av_at_intersection_tpu_torch.bench_profile import profile_controller

    k_steps, reps = 8, 5
    calls = (1 + reps) * k_steps
    reset_launches()
    report = profile_controller(batch=B, T=T, k_steps=k_steps, reps=reps, device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    print("controller profile: " + json.dumps(report))
    want = expected(build_qp=2 * calls + 1, solve_box_qp_fused=2 * calls,
                    ruiz_admm_all_rounds=calls + k_steps, polish_select=calls,
                    admm_iterations=calls, admm_round_full=calls, admm_all_rounds=calls)
    check(launches == want, f"controller profile: launches {launches}, want {want}")
    stages = {k: v for k, v in report.items() if k.endswith("_ms") and k != "unaccounted_ms"}
    check(all(np.isfinite(v) and v > 0 for v in stages.values()),
          f"controller profile: stages not finite and positive: {stages}")
    check(report["full_tick_solved_share"] >= 0.98,
          f"controller profile: full_tick solved share {report['full_tick_solved_share']}")
    for key in ("admm_checks_cold_hist", "admm_checks_warm_hist"):
        check(sum(report[key]) == B, f"controller profile: {key} sums to {sum(report[key])}")
    print(f"controller profile: launches {launches}")
    lap("19 controller profile")
    return {"launches": launches, "report": report}


def phase_profile_engine(dev):
    """Phase 20: the fleet tick profiler at B=1024: every stage finite,
    and the launches those of its ticks (K1 + K2 once per tick: the warm
    ticks, full_tick's and mpc's 1 + reps chains of k_steps, one for post's
    input)."""
    from mpc_for_av_at_intersection_tpu_torch.bench_profile_engine import profile_engine

    k_steps, reps, warm_ticks = 8, 5, 12
    ticks = warm_ticks + 2 * (1 + reps) * k_steps + 1
    reset_launches()
    report = profile_engine(batch=ENGINE_B, warm_ticks=warm_ticks, k_steps=k_steps, reps=reps,
                            device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    print("engine profile: " + json.dumps(report))
    want = expected(build_qp=ticks, solve_box_qp_fused=ticks)
    check(launches == want, f"engine profile: launches {launches}, want {want}")
    stages = {k: v for k, v in report.items()
              if k.endswith("_ms") and k not in ("unaccounted_ms", "conflict_ms")}
    check(all(np.isfinite(v) and v > 0 for v in stages.values()),
          f"engine profile: stages not finite and positive: {stages}")
    print(f"engine profile: launches {launches}")
    lap("20 engine profile")
    return {"launches": launches, "report": report}


def cuda_once_ms(fn):
    """(result, device ms) of one call, CUDA events around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_k3(dev):
    """Phases 7-8: K3 against its plain version on the 12 standard
    junctions, then at the planner's real width (1024 sampled geometries)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import (
        _prepare,
        astar_search_batch,
        astar_search_reference,
    )

    # ---- 7. the 12 standard junctions, 8192 expansions ----
    junctions, cfg, args, prims = k3_junction_inputs(dev)
    kern = astar_search_batch(*args, max_expansions=K3_JUNCTION_EXP)
    plain = astar_search_reference(*args, max_expansions=K3_JUNCTION_EXP)
    torch.cuda.synchronize()
    err = k3_check("12 junctions", kern, plain, args, prims, cfg, len(junctions), 1e-5,
                   len(junctions))
    digest = _digest(kern)
    print(f"K3 12 junctions, grid {cfg.nx}x{cfg.ny}x{cfg.ntheta}: expansions kernel "
          f"{kern.n_expansions.tolist()}, plain {plain.n_expansions.tolist()}; digest {digest}, "
          f"pinned {PINNED_DIGESTS['k3_junctions']}")
    check(digest == PINNED_DIGESTS["k3_junctions"], "K3 12 junctions: result differs from its pin")
    k3_junctions = kern
    lap("7 K3 standard junctions")

    # ---- 8. 1024 sampled geometries (api.py:536-575), 20000 expansions ----
    scen, cfg, args, prims = k3_geom_inputs(dev)
    S, max_exp = len(scen), K3_GEOM_EXP
    kern, _ = cuda_once_ms(lambda: astar_search_batch(*args, max_expansions=max_exp))
    times = [cuda_once_ms(lambda: astar_search_batch(*args, max_expansions=max_exp))[1]
             for _ in range(2)]
    ms = float(np.median(times))
    sub = tuple(a[:GEOM_PLAIN_ROWS] if isinstance(a, torch.Tensor) else a for a in args)
    plain, plain_ms = cuda_once_ms(lambda: astar_search_reference(*sub, max_expansions=max_exp))
    err = max(err, k3_check("1024 geometries", kern, plain, args, prims, cfg, GEOM_PLAIN_ROWS,
                            1e-4, int((kern.found[:GEOM_PLAIN_ROWS] & plain.found).sum()) - 2))
    digest = _digest(kern)
    check(digest == PINNED_DIGESTS["k3_geom"],
          f"K3 1024 geometries: result digest {digest} differs from its pin "
          f"{PINNED_DIGESTS['k3_geom']}")
    traj, n_pts, _, ok = replay(kern, args, prims, cfg)
    traj, n_pts, ok = traj.cpu().numpy(), n_pts.cpu().numpy(), ok.cpu().numpy()
    gap = max([scen[i].goal_area.distance_to_point(traj[i, n_pts[i] - 1, :2])
               for i in range(S) if ok[i]] or [0.0])
    check(gap < 0.15, f"K3 1024 geometries: a found course ends {gap} m from its goal area")
    bound_ms, bound_by = k3_bound(_prepare(*args, max_exp), kern)
    n_exp = kern.n_expansions.double()
    print(f"K3 1024 geometries, grid {cfg.nx}x{cfg.ny}x{cfg.ntheta}: found "
          f"{float(kern.found.double().mean()):.4f} of {S}; expansions mean "
          f"{float(n_exp.mean()):.0f}, max {int(n_exp.max())}; half-plane rows tested per "
          f"expansion {float(kern.rows_tested.double().sum() / n_exp.sum()):.1f}; "
          f"farthest course end from its "
          f"goal area {gap:.3g} m (bar 0.15); kernel {ms:.3f} ms (CUDA events, median of "
          f"{len(times)}; {ms * 1e3 / float(n_exp.max()):.3f} us per expansion of the longest "
          f"search), plain {plain_ms:.3f} ms on {GEOM_PLAIN_ROWS} rows; bound {bound_ms:.3f} ms "
          f"({bound_by}); {k3_kernel_report(cfg.n_cells)}; digest {digest} as pinned")
    lap("8 K3 sampled geometries")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "junction_cost": k3_junctions.cost.cpu(),
            "geom_cost": kern.cost.cpu(), "geom_found": kern.found.cpu()}


def sampled_junctions(S):
    """The sampled-geometry draws of api.py:536-549 for S scenarios."""
    from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

    rng = np.random.default_rng(SEED)
    start_d = [int(rng.choice((1, 2, 3, 4))) for _ in range(S)]
    turn_d = [int(rng.choice((1, 2, 3))) for _ in range(S)]
    road = rng.uniform(3.4, 5.2, size=S)
    island = rng.uniform(1.4, 3.0, size=S)
    corner = rng.uniform(5.0, 7.5, size=S)
    return [intersection(turn_indicator=turn_d[i], start_pos=start_d[i], road=float(road[i]),
                         island=float(island[i]), corner_radius=float(corner[i]))
            for i in range(S)]


def standard_junctions():
    from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

    return [intersection(turn_indicator=t, start_pos=s) for s in (1, 2, 3, 4) for t in (1, 2, 3)]


def phase_fleet(dev):
    """Phase 9: the fleet closed loop, planner and episodes on the card."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig, run_fleet_episodes
    from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes

    cfg = EngineConfig()
    reset_launches()
    geom, world, state, meta = api.sample_intersection_fleet_batched(
        FLEET_B, np.random.default_rng(SEED), n_steps=FLEET_T, planner="device", device=dev)
    final, tel, summary = run_batch_episodes(world, state, cfg, geom, FLEET_T)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(build_qp=FLEET_T, solve_box_qp_fused=FLEET_T, astar_search=1),
          f"fleet launches {launches}")
    stats = meta["planner_stats"]
    # every course of the fleet came from K3: none was re-planned on the host
    n_keys = len(set(zip(meta["start_pos"].tolist(), meta["turn_indicator"].tolist())))
    check(stats["n_host_fallback"] == 0 and stats["n_device"] == n_keys,
          f"fleet planner: {stats['n_device']} courses from K3, {stats['n_host_fallback']} host "
          f"fallbacks, {n_keys} (start, turn) keys")
    shares = []
    for t in range(FLEET_T):
        live = ~tel.done[:, t]
        shares.append(float(tel.solved[live, t].float().mean()) if bool(live.any()) else 1.0)
    check(min(shares) >= 0.98, f"fleet: solved share over live rows {min(shares)}")
    check(bool(final.ego.isfinite().all()) and bool(tel.x.isfinite().all())
          and bool(tel.steer.isfinite().all()), "fleet: states went non-finite")
    print(f"fleet: {FLEET_B} scenarios x {FLEET_T} ticks, T={cfg.mpc.T}; launches {launches}; "
          f"planner {stats['n_device']} courses on the card, {stats['n_host_fallback']} host "
          f"fallbacks, {stats['seconds']:.2f} s; solved share over live rows min "
          f"{min(shares):.4f}; done {int(summary['n_done'])}, unsolved ticks "
          f"{int(summary['n_unsolved_ticks'])}, collisions flagged "
          f"{int(tel.collision_found.sum())}")

    # the bench bracket (bench.py:152-163): a second run, host clock, ended
    # by a value fetch
    t0 = time.perf_counter()
    _, _, summary = run_batch_episodes(world, state, cfg, geom, FLEET_T)
    int(summary["n_done"])
    fleet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_fleet_episodes(world, state, cfg, geom, FLEET_T, use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    print(f"fleet rate: {FLEET_B * FLEET_T / fleet_s:.1f} scenario ticks/s through the kernels "
          f"({fleet_s * 1e3 / FLEET_T:.2f} ms per tick), plain path on the card "
          f"{FLEET_B * FLEET_T / plain_s:.1f} ({plain_s * 1e3 / FLEET_T:.2f} ms per tick); "
          f"planning {stats['seconds']:.2f} s, {stats['n_host_fallback']} host fallbacks")

    fleet_profile(world, state, cfg, geom)

    compare_with_cpu_plain("fleet", world, state, cfg, geom, FLEET_T - 1)
    lap("9 fleet")
    return {"launches": launches, "world": world, "state": state, "geom": geom}


def k4_bound(ep, packed, rows):
    """K4's bound on this input: the poses, the packed geometry and the
    (B, F, P) flags, each moved once; 4 operations per half-plane row the
    kernel evaluates (``rows_tested``: a point stops at an obstacle's first
    violated row and at its first obstacle hit) and 8 per point placed."""
    B, F, _ = ep.shape
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (ep, packed.hp, packed.ov, packed.cc, packed.cc_mask))
              + B * F * packed.n_prims)
    flops = 4 * float(rows.double().sum()) + 8 * B * F * int(packed.cc_mask.sum())
    return _bound(nbytes, flops)


def k4_mismatch_report(ep, packed, kern, plain):
    """For each mask that differs, the least |distance| of the candidate's
    points to a half-plane boundary of a live obstacle."""
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import HH

    bad = (kern != plain).nonzero().tolist()
    for b, f, p in bad[:10]:
        C = packed.cc.shape[0] // packed.n_prims
        pts = packed.cc[p * C:(p + 1) * C]
        c, s = torch.cos(ep[b, f, 2]), torch.sin(ep[b, f, 2])
        wx = ep[b, f, 0] + c * pts[:, 0] - s * pts[:, 1]
        wy = ep[b, f, 1] + s * pts[:, 0] + c * pts[:, 1]
        hp = packed.hp[b][packed.ov[b]].reshape(-1, 3)
        nrm = torch.hypot(hp[:, 0], hp[:, 1]).clamp(min=1e-9)
        dist = ((wx[:, None] * hp[:, 0] + wy[:, None] * hp[:, 1] + hp[:, 2]) / nrm).abs()
        print(f"K4 mismatch row {b} frontier {f} primitive {p}: kernel {bool(kern[b, f, p])}, "
              f"plain {bool(plain[b, f, p])}; least distance to a half-plane "
              f"{float(dist.min()):.3g} m ({HH} rows per obstacle)")
    return len(bad)


def phase_beam(dev, k3):
    """Phases 10-11: the beam engine at width on the 1024 sampled
    geometries (K4 once per iteration), and K4 against its plain version on
    the inputs of three of that run's iterations."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import wavefront
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.ops import collision

    geom = bicycle_geometry()
    scen = sampled_junctions(GEOM_B)
    _, cfg = wavefront.grid_for(scen, "beam")
    marks = {0: None, cfg.iters // 2: None, cfg.iters - 1: None}
    calls = [0]
    real = wavefront.frontier_collision

    def recording(ep, packed):
        if calls[0] in marks:
            marks[calls[0]] = ep.clone()
        calls[0] += 1
        recording.packed = packed
        return real(ep, packed)

    # ---- 11 (main path). the beam engine on the 1024 sampled geometries ----
    wavefront.frontier_collision = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    collision.frontier_collision.launches = 0
    try:
        t0 = time.perf_counter()
        res = wavefront.plan_courses_device(scen, geom, cfg=cfg, engine="beam", device=dev)
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
    finally:
        wavefront.frontier_collision = real
    launches = collision.frontier_collision.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == cfg.iters == calls[0],
          f"beam: K4 launched {launches} times over {cfg.iters} iterations")
    packed = recording.packed
    lap("11a beam at width")

    # ---- 10. K4 vs plain on three iterations' inputs, first rows ----
    R = BEAM_PLAIN_ROWS
    sub = packed._replace(hp=packed.hp[:R], ov=packed.ov[:R], live=packed.live[:R],
                          n_live=packed.n_live[:R])
    n_bad = 0
    for it, ep in marks.items():
        kern = collision.frontier_collision(ep, packed)
        plain = collision.frontier_collision_reference(ep[:R], sub)
        n_bad += k4_mismatch_report(ep, packed, kern[:R], plain)
        print(f"K4 iteration {it}: {int(plain.sum())} of {plain.numel()} candidates collide on "
              f"{R} rows; masks differ on {int((kern[:R] != plain).sum())}")
    check(n_bad == 0, f"K4: {n_bad} masks differ from the plain version")
    ep_mid = marks[cfg.iters // 2]
    k4_ms = cuda_ms(lambda: collision.frontier_collision(ep_mid, packed), 20)
    _, k4_plain_ms = cuda_once_ms(lambda: collision.frontier_collision_reference(ep_mid[:R], sub))
    rows = collision.rows_tested(ep_mid, packed)
    bound_ms, bound_by = k4_bound(ep_mid, packed, rows)
    B, F, _ = ep_mid.shape
    n_pts = int(packed.cc_mask.sum())
    print(f"K4 at B={B}, F={F}, {packed.n_prims} primitives x {n_pts // packed.n_prims} points, "
          f"{packed.hp.shape[1]} obstacle slots: kernel {k4_ms:.3f} ms (CUDA events, median of "
          f"20, iteration {cfg.iters // 2}'s input), plain {k4_plain_ms:.3f} ms on {R} rows; "
          f"half-plane rows tested per point {float(rows.double().sum()) / (B * F * n_pts):.2f}; "
          f"bound {bound_ms:.4f} ms ({bound_by}); launches {launches}; "
          f"{k4_kernel_report(packed.cc.shape[0])}")
    lap("10 K4")

    # ---- 11. the beam's results ----
    plain_res = wavefront.plan_courses_device(scen[:R], geom, cfg=cfg, engine="beam",
                                              collision="plain", device=dev)
    for name in ("found", "cost", "n_edges", "oob"):
        same = bool((getattr(res, name)[:R] == getattr(plain_res, name)).all())
        check(same, f"beam: {name} differs between K4 and the plain collision on {R} rows")
    found = res.found.cpu()
    traj, n_pts, cost = res.trajectory.cpu().numpy(), res.n_points.cpu().numpy(), res.cost.cpu()
    start_gap = max([float(np.abs(traj[i, 0] - np.asarray(scen[i].start)).max())
                     for i in range(GEOM_B) if found[i]] or [0.0])
    end_gap = max([scen[i].goal_area.distance_to_point(traj[i, n_pts[i] - 1, :2])
                   for i in range(GEOM_B) if found[i]] or [0.0])
    check(start_gap < 1e-4, f"beam: a found course starts {start_gap} from its start pose")
    check(end_gap < 0.15, f"beam: a found course ends {end_gap} m from its goal area")
    both = found & k3["geom_found"]
    ratio = (cost[both].double() / k3["geom_cost"][both].double())
    qs = quantiles(ratio, (0.0, 0.5, 0.95, 1.0))

    junctions = standard_junctions()
    r12 = wavefront.plan_courses_device(junctions, geom, engine="beam", device=dev)
    c12, k12 = r12.cost.cpu().double(), k3["junction_cost"].double()
    in_band = ((c12 >= 0.85 * k12 - 1e-6) & (c12 <= 1.10 * k12 + 1e-6))
    check(bool(r12.found.all()), f"beam: 12 junctions found {r12.found.tolist()}")
    check(int(in_band.sum()) >= int(np.ceil(0.95 * len(junctions))),
          f"beam: {int(in_band.sum())} of 12 costs in 0.85-1.10 x K3's")

    key = torch.randint(0, 2 ** 62, (GEOM_B, cfg.n_cells), device=dev)
    topk_ms = cuda_ms(lambda: torch.topk(key, cfg.frontier, dim=1, largest=False), 5)
    del key
    print(f"beam at width: {GEOM_B} sampled geometries, grid {cfg.nx}x{cfg.ny}x{cfg.ntheta} "
          f"({cfg.n_cells} cells), F={cfg.frontier}, {cfg.iters} iterations: {beam_s:.2f} s "
          f"({beam_s * 1e3 / cfg.iters:.1f} ms per iteration), peak device memory "
          f"{peak_gb:.2f} GB; top-F selection (int64 topk over the grid) {topk_ms:.3f} ms per "
          f"iteration; found {float(found.double().mean()):.4f}; courses start within "
          f"{start_gap:.2g} of their start and end within {end_gap:.3g} m of their goal area "
          f"(bar 0.15); beam/K3 cost on {int(both.sum())} rows both found: min/p50/p95/max "
          f"{qs[0]:.4f}/{qs[1]:.4f}/{qs[2]:.4f}/{qs[3]:.4f}; K4 vs plain collision on {R} "
          f"rows: found, cost, n_edges and oob equal; 12 junctions all found, "
          f"{int(in_band.sum())}/12 in 0.85-1.10 x K3's cost (ratios "
          f"{', '.join(f'{v:.3f}' for v in (c12 / k12).tolist())})")
    lap("11 beam")
    return {"launches": launches, "err": n_bad, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_geom_fleet(dev):
    """Phase 12: the sampled-geometry Monte-Carlo fleet, built with the
    device planner (K3 once, the native core for misses and redraws), then
    1024 scenarios x 128 ticks."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import EngineConfig
    from mpc_for_av_at_intersection_tpu_torch.native import native_available
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch
    from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes

    check(native_available(), "the native host search did not build (g++)")

    def python_search(*args, **kwargs):
        raise RuntimeError("chip_smoke: the Python host search ran; only the native core may")

    python = api.MotionPrimitiveSearch
    api.MotionPrimitiveSearch = python_search
    reset_launches()
    try:
        t0 = time.perf_counter()
        geom, world, state, meta = api.sample_intersection_fleet_geom(
            GEOM_FLEET_B, np.random.default_rng(SEED), n_steps=GEOM_FLEET_T, planner="device",
            device=dev)
        build_s = time.perf_counter() - t0
    finally:
        api.MotionPrimitiveSearch = python
    stats = meta["planner_stats"]
    check(astar_search_batch.launches == 1, f"geometry fleet: K3 launched "
          f"{astar_search_batch.launches} times")
    check(bool((world.n_course > 1).all()), "geometry fleet: a course is missing")
    print(f"geometry fleet build: {GEOM_FLEET_B} sampled junctions in {build_s:.2f} s; "
          f"n_device {stats['n_device']}, n_host_fallback {stats['n_host_fallback']} "
          f"(native core, {stats['host_fallback_seconds']:.2f} s, {stats['n_unplannable']} "
          f"with no path at 150k), n_resampled_geometry {stats['n_resampled_geometry']}; "
          f"course lengths {int(world.n_course.min())}-{int(world.n_course.max())} of "
          f"{world.course.shape[1]}")
    lap("12a geometry fleet build")

    # bench_montecarlo.py:69 runs EngineConfig() on these worlds (n_traj
    # only sizes the course buffer, which the builder already made)
    cfg = EngineConfig()
    reset_launches()
    final, tel, summary = run_batch_episodes(world, state, cfg, geom, GEOM_FLEET_T)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == expected(build_qp=GEOM_FLEET_T, solve_box_qp_fused=GEOM_FLEET_T),
          f"geometry fleet launches {launches}")
    live = ~tel.done
    shares = [float(tel.solved[live[:, t], t].float().mean()) if bool(live[:, t].any()) else 1.0
              for t in range(GEOM_FLEET_T)]
    check(min(shares) >= 0.98, f"geometry fleet: solved share over live rows {min(shares)}")
    check(bool(final.ego.isfinite().all()) and bool(tel.x.isfinite().all())
          and bool(tel.steer.isfinite().all()), "geometry fleet: states went non-finite")
    print(f"geometry fleet: {GEOM_FLEET_B} scenarios x {GEOM_FLEET_T} ticks; launches "
          f"{launches}; solved share over live rows min {min(shares):.4f}; done "
          f"{int(summary['n_done'])}, unsolved ticks {int(summary['n_unsolved_ticks'])}")

    # bench_montecarlo.py's bracket: a second run, host clock, ended by a
    # value fetch
    t0 = time.perf_counter()
    final, _, _ = run_batch_episodes(world, state, cfg, geom, GEOM_FLEET_T)
    final.done.cpu()
    run_s = time.perf_counter() - t0
    print(f"geometry fleet rate: warm_scenario_ticks_per_s "
          f"{GEOM_FLEET_B * GEOM_FLEET_T / run_s:.1f} ({run_s * 1e3 / GEOM_FLEET_T:.2f} ms per "
          f"tick)")
    compare_with_cpu_plain("geometry fleet", world, state, cfg, geom, 31)
    lap("12 geometry fleet")
    return {"launches": launches}


def compare_with_cpu_plain(tag, world, state, cfg, geom, last, long_horizon=False):
    """Ticks 0 and ``last`` from the card's state, on the CPU plain path,
    first FLEET_CPU_ROWS rows: agent_idx, cutoff_len, collision_found and
    done exactly equal, controls p95 <= 2e-3. ``long_horizon`` (phase 27,
    past T=31, where two float32 solvers part) holds the controls as
    ``tick_loop`` holds phase 26's instead: against the CPU float64 tick
    from the same state, the card's error quantiles p50 and p90 at most
    1.5x the float32 plain path's + 1e-5 and its rows off by > 2e-2 at most
    the plain path's + max(2, 1% of the rows); the rows both solve at least
    ``plain_share_bar`` of the plain path's share (p95 printed, not
    gated)."""
    from mpc_for_av_at_intersection_tpu_torch.engine import (
        engine_state_from_numpy,
        engine_state_to_numpy,
        engine_tick_fleet,
        run_fleet_episodes,
        world_from_numpy,
        world_to_numpy,
    )
    from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map

    def f64(t):
        return t.double() if t.is_floating_point() else t

    def ctl(tel):
        return torch.stack([tel.accel.cpu(), tel.steer.cpu()], 1).double()

    st_last, _ = run_fleet_episodes(world, state, cfg, geom, last)
    rows = slice(0, FLEET_CPU_ROWS)
    w_cpu = world_from_numpy(_rows_of(world_to_numpy(world), rows), device="cpu")
    for tick, st in ((0, state), (last, st_last)):
        card_st, card_tel = engine_tick_fleet(world, st, cfg, geom)
        st_cpu = engine_state_from_numpy(_rows_of(engine_state_to_numpy(st), rows), "cpu")
        cpu_st, cpu_tel = engine_tick_fleet(w_cpu, st_cpu, cfg, geom)
        exact = {
            "agent_idx": bool((card_st.agent_idx[rows].cpu() == cpu_st.agent_idx).all()),
            "cutoff_len": bool((card_tel.cutoff_len[rows].cpu() == cpu_tel.cutoff_len).all()),
            "collision_found": bool((card_tel.collision_found[rows].cpu()
                                     == cpu_tel.collision_found).all()),
            "done": bool((card_tel.done[rows].cpu() == cpu_tel.done).all()),
        }
        both = (card_tel.solved[rows].cpu() & cpu_tel.solved & ~cpu_tel.done)
        d = (ctl(card_tel)[rows] - ctl(cpu_tel)).abs()[both]
        p95 = float(d.quantile(0.95, dim=0).max()) if len(d) else 0.0
        more = ""
        if long_horizon:
            _, tel64 = engine_tick_fleet(tree_map(f64, w_cpu), tree_map(f64, st_cpu), cfg, geom)
            all3 = both & tel64.solved
            ek = (ctl(card_tel)[rows] - ctl(tel64)).abs().amax(1)[all3]
            ep = (ctl(cpu_tel) - ctl(tel64)).abs().amax(1)[all3]
            qk, qp_ = quantiles(ek), quantiles(ep)
            tail_k, tail_p = int((ek > 2e-2).sum()), int((ep > 2e-2).sum())
            live = int((~cpu_tel.done).sum())
            need = live * plain_share_bar(
                float(cpu_tel.solved[~cpu_tel.done].float().mean()) if live else 1.0,
                max(live, 1))
            more = (f"; error vs the float64 tick p50/p90/p99 card {qk[0]:.3g}/{qk[1]:.3g}/"
                    f"{qk[2]:.3g}, float32 plain {qp_[0]:.3g}/{qp_[1]:.3g}/{qp_[2]:.3g} (gated "
                    f"p50/p90); rows off it by > 2e-2: card {tail_k}, float32 plain {tail_p}")
        print(f"{tag} tick {tick} vs CPU plain ({FLEET_CPU_ROWS} rows, {int(both.sum())} both "
              f"solved): exact {exact}; controls p95 {p95:.3g} "
              f"({'not gated' if long_horizon else 'bar 2e-3'}), max "
              f"{float(d.max()) if len(d) else 0.0:.3g}{more}")
        check(all(exact.values()), f"{tag} tick {tick}: {exact}")
        if not long_horizon:
            check(p95 <= 2e-3, f"{tag} tick {tick}: controls p95 {p95}")
            continue
        check(int(both.sum()) >= need, f"{tag} tick {tick}: {int(both.sum())} rows solved by "
              f"both < {need}")
        for q, a, b in zip((50, 90), qk, qp_):
            check(a <= 1.5 * b + 1e-5,
                  f"{tag} tick {tick}: p{q} error vs the float64 tick {a} > 1.5 x plain {b}")
        check(tail_k <= tail_p + max(2, FLEET_CPU_ROWS // 100),
              f"{tag} tick {tick}: {tail_k} rows off the float64 tick, float32 plain {tail_p}")


def fleet_profile(world, state, cfg, geom, ticks=3, tag="fleet tick"):
    """Where a fleet tick's time goes (``tick_profile`` of
    ``engine_tick_fleet``)."""
    from mpc_for_av_at_intersection_tpu_torch.engine import engine_tick_fleet

    return tick_profile(tag, lambda st: engine_tick_fleet(world, st, cfg, geom)[0], state, ticks)


def tick_profile(tag, step, state, ticks=3):
    """Where a tick's time goes: device time by kernel over a few warm
    ticks (``step(state) -> state``) under torch.profiler, against the
    host clock."""
    from torch.profiler import ProfilerActivity, profile

    st = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            st = step(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"{tag} profile ({ticks} warm ticks): {wall_ms:.2f} ms wall, {dev_ms:.2f} ms device "
          f"({dev_ms / wall_ms:.1%} busy), {sum(e.count for e in kernels) // ticks} kernels per "
          "tick; top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3 / ticks:.3f} ms x{e.count // ticks}"
              for e in top))
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "by_kernel": {e.key: e.self_device_time_total / 1e3 / ticks for e in kernels}}


def _rows_of(d, rows):
    """The first rows of every array in a nested dict."""
    return {k: _rows_of(v, rows) if isinstance(v, dict) else v[rows] for k, v in d.items()}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main_digests() -> int:
    """``--digests``: print ``kernel_digests`` and ``k3_digests`` of this
    checkout's kernels."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig

    dev = torch.device("cuda", 0)
    inputs, oa, od, ref = headline_inputs(dev)
    out = kernel_digests(k1_inputs(inputs, oa, od, ref), solver_kw(MPCConfig(T=T)))
    del inputs, oa, od, ref
    from mpc_for_av_at_intersection_tpu_torch.ops import admm

    if hasattr(admm, "cluster_size"):   # a version that serves T=40 on clusters
        cfg = MPCConfig(T=LONG_T, dt=LONG_DT)
        out.update(long_digests(long_inputs(dev, cfg)[1], solver_kw(cfg)))
    print(json.dumps({**out, **k3_digests(dev)}))
    return 0


def main_long_horizon() -> int:
    """``--long-horizon``: phase 26 alone, after the device line and the
    build, and its kernels' entries of the ``kernels`` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi_line = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}")
    _build.load()
    lap("build")
    print(json.dumps({"kernels": long_horizon_kernels(phase_long_horizon(dev, smi_line))}))
    return 0


def main_fleets() -> int:
    """``--fleets``: phases 22 and 27 alone, after the device line and the
    build."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi_line = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}")
    _build.load()
    lap("build")
    phase_multi_ego(dev, smi_line)
    torch.cuda.empty_cache()
    phase_long_fleet(dev, smi_line)
    return 0


def main_long_numerics() -> int:
    """``--long-horizon-numerics``: one JSON line per measurement of where
    K2's float32 arithmetic and the plain solver's part as the horizon
    grows, on the headline generator's inputs (B=4096), for T=20 at
    dt=0.2, T=40 at dt=0.1 (phase 26) and T=40 at dt=0.2 (an 8 s
    look-ahead). ``tick``: closed loop as phase 26 on the kernel path; at
    ticks 0, 5 and 20 the tick from the same state with K1 or its plain
    version and K2 or the plain solver (``kk``, ``kp``, ``pk``, ``pp``),
    each row's controls against the float64 plain tick: p50/p90/p99/p99.9
    over the rows all five solve, rows off by > 2e-2, solved share.
    ``qp``: on the cold tick's QP, K2 (cold; warm from the plain solver's
    cold output) and A/B-1 (cold; warm from its own cold output, as a
    closed loop would) against their plain versions: rows the float64
    optimum certifies, rows solved, rows off it by > 2e-2 among the
    certified, rows polished, mean check blocks; also T=32, T=48 and the
    jerk variant at T=40."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.core import SimLimits, plant_step
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
    from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import ruiz_admm_batched, solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        ruiz_admm_all_rounds,
        solve_box_qp,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    wheelbase = bicycle_geometry().wheelbase
    card = nvidia_smi_line()

    def as64(c):
        return c._replace(**{k: v.double() for k, v in c._asdict().items()
                             if v.is_floating_point()})

    for T_, dt in ((20, 0.2), (LONG_T, LONG_DT), (LONG_T, 0.2)):
        cfg = MPCConfig(T=T_, dt=dt)
        inputs, _ = long_inputs(dev, cfg)
        states = inputs[0]
        limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                           min_speed=cfg.min_speed)
        cs = init_controller_state(cfg, device=dev, batch=B)
        for tick in range(21):
            if tick in (0, 5, 20):
                args = (states,) + inputs[1:] + (cs, cfg, wheelbase)
                runs = {"kk": (build_qp, solve_box_qp), "kp": (build_qp, solve_box_qp_batched),
                        "pk": (build_qp_reference, solve_box_qp),
                        "pp": (build_qp_reference, solve_box_qp_batched)}
                res = {k: _mpc_step(*args, *fns) for k, fns in runs.items()}
                p64 = _mpc_step(states.double(), inputs[1].double(), inputs[2].double(),
                                inputs[3], inputs[4].double(), as64(cs), cfg, wheelbase,
                                build_qp_reference, solve_box_qp_batched)
                ok = p64.solved.cpu()
                for v in res.values():
                    ok &= v.solved.cpu()
                line = {"tick": {"T": T_, "dt": dt, "tick": tick, "rows": int(ok.sum())}}
                for k, v in res.items():
                    e = (controls(v) - controls(p64)).abs().amax(1)[ok]
                    line[k] = {"p50/p90/p99/p99.9": quantiles(e, (0.5, 0.9, 0.99, 0.999)),
                               "off_2e-2": int((e > 2e-2).sum()),
                               "solved": float(v.solved.float().mean())}
                print(json.dumps({**line, "card": card}), flush=True)
            out = mpc_step_batched(states, *inputs[1:], cs, cfg, wheelbase)
            states = plant_step(states, torch.stack([out.accel, out.steer], -1), cfg.dt,
                                wheelbase, limits)
            cs = out.state
    for T_, dt, jerk in ((20, 0.2, False), (32, 0.1, False), (32, 0.2, False),
                         (LONG_T, LONG_DT, False), (LONG_T, 0.2, False), (LONG_T, LONG_DT, True),
                         (LONG_T, 0.2, True), (LONG48_T, LONG_DT, False), (LONG48_T, 0.2, False)):
        cfg = dataclasses.replace(MPCConfig.with_jerk() if jerk else MPCConfig(), T=T_, dt=dt)
        q = build_qp(*long_inputs(dev, cfg)[1])
        qp = (q.P, q.q, q.G, q.lo, q.hi)
        kw = solver_kw(cfg)
        x_true, cert = true_solution(qp)

        def row(sol):
            e = (sol.x.double() - x_true).abs().amax(1)[cert]
            return [int(solved_mask(sol).sum()), int((e > 2e-2).sum()), int(sol.polished.sum()),
                    round(float(sol.checks.mean()), 4)]

        k2c, p2c = solve_box_qp_fused(*qp, **kw), solve_box_qp_batched(*qp, **kw)
        w = (p2c.x, p2c.y, p2c.rho)
        a1k, a1p = ruiz_admm_all_rounds(*qp, **kw), ruiz_admm_batched(*qp, **kw)
        line = {"T": T_, "dt": dt, "jerk": jerk, "certified": int(cert.sum()),
                "[solved, off 2e-2, polished, checks] kernel, plain": {
                    "K2 cold": [row(k2c), row(p2c)],
                    "K2 warm": [row(solve_box_qp_fused(*qp, warm=w, **kw)),
                                row(solve_box_qp_batched(*qp, warm=w, **kw))],
                    "A/B-1 cold": [row(a1k), row(a1p)],
                    "A/B-1 warm": [row(ruiz_admm_all_rounds(*qp, warm=(a1k.x, a1k.y, a1k.rho), **kw)),
                                   row(ruiz_admm_batched(*qp, warm=(a1p.x, a1p.y, a1p.rho), **kw))]}}
        print(json.dumps({"qp": line, "card": card}), flush=True)
        del x_true, cert, qp, q
        torch.cuda.empty_cache()
    return 0


# ``--tail-sample``: the T=40 warm tick's QPs built on the CPU's plain path
TAIL_ROWS = 1024     # the headline generator's first rows
TAIL_TICKS = 5       # closed-loop ticks before the sampled (warm) tick
TAIL_KEEP = 32       # rows of K2's tail kept, and as many spread over the rest


def tail_qps(rows, ticks=TAIL_TICKS):
    """The QPs of a warm ``MPCConfig(T=40, dt=0.1)`` tick on the CPU: the
    headline generator's ``rows`` (a count of first rows or an index array
    into its B rows), run ``ticks`` closed-loop ticks through the plant on
    the plain path, then the next tick's box-QP (P, q, G, lo, hi) and its
    warm start (x, y, rho), float32 CPU tensors. Rows are independent, so a
    row's QP does not depend on the others drawn with it."""
    from mpc_for_av_at_intersection_tpu_torch.core import SimLimits, plant_step
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, batch, init_controller_state

    cfg = MPCConfig(T=LONG_T, dt=LONG_DT)
    cpu = torch.device("cpu")
    inputs, _ = long_inputs(cpu, cfg)
    idx = torch.arange(rows) if isinstance(rows, int) else torch.as_tensor(rows)
    inputs = tuple(t[idx] for t in inputs)
    wheelbase = bicycle_geometry().wheelbase
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed, min_speed=cfg.min_speed)
    cs = init_controller_state(cfg, device=cpu, batch=len(idx))
    states = inputs[0]
    for _ in range(ticks):
        out = batch.mpc_step_batched(states, *inputs[1:], cs, cfg, wheelbase)
        states = plant_step(states, torch.stack([out.accel, out.steer], -1), cfg.dt, wheelbase,
                            limits)
        cs = out.state
    seen, solve = [], batch.solve_box_qp

    def capture(P, q, G, lo, hi, warm=None, **kw):
        seen.append(((P, q, G, lo, hi), warm))
        return solve(P, q, G, lo, hi, warm=warm, **kw)

    batch.solve_box_qp = capture
    try:
        batch.mpc_step_batched(states, *inputs[1:], cs, cfg, wheelbase)
    finally:
        batch.solve_box_qp = solve
    return seen[-1]


def main_tail_sample() -> int:
    """``--tail-sample``: where K2's float32 tail at T=40 comes from. On
    ``tail_qps(TAIL_ROWS)`` (built on the CPU), K2 on the card, the plain
    solver on the card and on the CPU, each warm-started as the tick does,
    against the float64 optimum (``true_solution``, on the card): one JSON
    line of each one's error quantiles over the certified rows and its
    rows off by > 2e-2; the TAIL_KEEP rows where K2 is farthest from the
    optimum and as many others, spread over the certified rows, are
    written with their QPs, warm starts and each solver's x to the
    package's ``_build/tail_sample.npz`` (held there to the JAX package's
    fused kernel by ``tests/test_torch_admm_tail.py``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    qp_cpu, warm_cpu = tail_qps(TAIL_ROWS)
    build_s = time.perf_counter() - t0
    kw = solver_kw(MPCConfig(T=LONG_T, dt=LONG_DT))
    qp = tuple(a.to(dev) for a in qp_cpu)
    warm = tuple(a.to(dev) for a in warm_cpu)
    x_true, cert = true_solution(qp)
    sols = {"k2": solve_box_qp_fused(*qp, warm=warm, **kw),
            "plain_card": solve_box_qp_batched(*qp, warm=warm, **kw),
            "plain_cpu": solve_box_qp_batched(*qp_cpu, warm=warm_cpu, **kw)}
    err = {k: (s.x.to(dev).double() - x_true).abs().amax(1) for k, s in sols.items()}
    line = {"rows": TAIL_ROWS, "ticks": TAIL_TICKS, "build_s": build_s,
            "certified": int(cert.sum()), "card": nvidia_smi_line()}
    for k, e in err.items():
        ec = e[cert]
        line[k] = {"p50/p90/p99/max": quantiles(ec, (0.5, 0.9, 0.99, 1.0)),
                   "off_2e-2": int((ec > 2e-2).sum()),
                   "polished": int(sols[k].polished.sum()),
                   "solved": int(solved_mask(sols[k]).sum())}
    rows = torch.nonzero(cert).flatten()
    worst = rows[err["k2"][rows].argsort(descending=True)[:TAIL_KEEP]]
    rest = rows[~torch.isin(rows, worst)]
    keep = torch.cat([worst, rest[torch.linspace(0, len(rest) - 1, TAIL_KEEP).long()]]).cpu()
    line["kept_rows"] = keep.tolist()
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(_build.BUILD_DIR / "tail_sample.npz", rows=keep.numpy(),
             **{k: a[keep].numpy() for k, a in zip(("P", "q", "G", "lo", "hi"), qp_cpu)},
             **{k: a[keep].numpy() for k, a in zip(("x0", "y0", "rho0"), warm_cpu)},
             x_true=x_true[keep.to(dev)].cpu().numpy(),
             **{f"x_{k}": s.x[keep.to(s.x.device)].cpu().numpy() for k, s in sols.items()})
    print(json.dumps(line), flush=True)
    return 0


def main_astar_times() -> int:
    """``--astar-times``: one JSON line of K3 at phase 8's inputs: the
    CUDA-event median of 5 launches, the longest search's expansions and the
    microseconds per expansion that gives, the peak device memory of one
    call above its inputs, K3's CTAs per SM, registers and spills
    (``k3_kernel_report``) and the result's digest. Run it with two
    checkouts' packages in one call to compare them."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    _, cfg, args, _ = k3_geom_inputs(dev)

    def run():
        return astar_search_batch(*args, max_expansions=K3_GEOM_EXP)

    res = run()
    digest, longest = _digest(res), int(res.n_expansions.max())
    del res
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(run, 5)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0], "k3_ms": ms,
                      "longest_search": longest, "us_per_expansion": ms * 1e3 / longest,
                      "peak_gib": peak / 2**30, "kernel": k3_kernel_report(cfg.n_cells),
                      "k3_geom": digest}))
    return 0


def main_solve_times() -> int:
    """``--solve-times``: one JSON line of CUDA-event medians of the
    ADMM-family kernels on the headline generator's QPs: K2 (cold and
    warm), A/B-1 and A/B-2 (warm, on A/B-1's output), warm-started as phase
    5 does, at T=20 and at the fleet's T=13; Probe-3 at one check block and
    at ``admm_iters`` iterations, Probe-1 and Probe-2 on phase 18's inputs;
    each kernel's CTAs per SM and registers; the clock64() split of A/B-1
    and K2 (``stamped_admm_source``: cycles a CTA in load, Ruiz, scaled
    problem + z start + G'G, factorizations, iterations, residual checks,
    unscale, the polish's sections, store) at B=4096, T=20 cold and warm
    and T=13 warm, and of A/B-2 on A/B-1's warm output;
    the cluster kernels at T=40 (``long_solve_times``, split per rank,
    the polish's sections too); the cycles of a barrier
    (``cluster_sync_cycles``);
    and the median warm tick of the canonical, jerk and unpolished
    controllers at T=20 (``warm_tick_ms``). Run it with two checkouts'
    packages in one call to compare them on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
        _ruiz_equilibrate,
        scale_qp,
        solve_box_qp_batched,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    result = {"card": smi.stdout.strip().splitlines()[0]}
    for horizon in (T, 13):
        cfg = MPCConfig(T=horizon)
        inputs, oa, od, ref = headline_inputs(dev, horizon)
        kw = solver_kw(cfg)
        qp_k = build_qp(*k1_inputs(inputs, oa, od, ref, cfg))
        qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
        cold = solve_box_qp_batched(*qp, **kw)
        warm = (cold.x, cold.y, cold.rho)
        ab1 = ruiz_admm_all_rounds(*qp, warm=warm, **kw)
        n, m = qp[1].shape[1], qp[3].shape[1]
        times = {
            "k2_cold_ms": cuda_ms(lambda: solve_box_qp_fused(*qp, **kw), 5),
            "k2_warm_ms": cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 10),
            "ab1_warm_ms": cuda_ms(lambda: ruiz_admm_all_rounds(*qp, warm=warm, **kw), 10),
            "ab2_warm_ms": cuda_ms(lambda: polish_select(*qp, ab1), 10),
            "ab2_active_rows": active_rows(polish_select(*qp, ab1))}
        times["split"] = {
            f"{name} {start}": section_split(
                "admm.cu", lambda: solve(*qp, **({"warm": warm} if start == "warm" else {}), **kw),
                qp[1].shape[0], stamped_admm_source)
            for name, solve in (("A/B-1", ruiz_admm_all_rounds), ("K2", solve_box_qp_fused))
            for start in (("warm", "cold") if horizon == T else ("warm",))}
        times["split"]["A/B-2 on A/B-1's warm output"] = section_split(
            "admm.cu", lambda: polish_select(*qp, ab1), qp[1].shape[0], stamped_admm_source)
        if horizon == T:
            scaled = scale_qp(*qp, *_ruiz_equilibrate(qp_k.P, qp_k.q, qp_k.G))
            probes = probe_inputs(scaled, cfg)
            for name, (kern, _) in probe_functions().items():
                args, start, tail = probes[name]
                times[f"{name}_ms"] = cuda_ms(lambda: kern(*args, *start, *tail), 10)
            times["admm_iterations_block_ms"] = probe3_ms(scaled, cfg, cfg.admm_check_iters, 10)
            times["iteration_us_per_cta"] = per_iteration_us(
                times["admm_iterations_ms"], times["admm_iterations_block_ms"], cfg, B, n, m)
            times["warm_tick_ms"] = {
                name: warm_tick_ms(c, inputs) for name, c in (
                    ("canonical", cfg), ("jerk", dataclasses.replace(MPCConfig.with_jerk(), T=T)),
                    ("unpolished", dataclasses.replace(cfg, polish=False)))}
        times["kernels"] = admm_kernel_report(n, m)
        result[f"n={n},m={m}"] = times
    result.update(long_solve_times(dev))
    result["barrier_cycles"] = cluster_sync_cycles()
    print(json.dumps(result))
    return 0


def long_solve_times(dev):
    """{"n=80,m=159": ...}: the cluster kernels on phase 26's T=40 QP
    (``MPCConfig(T=40, dt=0.1)``, B=4096, the headline generator's cold
    tick), warm-started from the plain solver's cold solution as
    ``--solve-times`` does at T=20: K2 cold and warm, A/B-1 warm and A/B-2
    on A/B-1's output, each as (median, least, most) of groups of calls
    (``cuda_spread``), K2 and A/B-1 warm also on each larger cluster (the
    wrappers' forced launches); the clock64() split of K2 and A/B-1, cold and warm,
    over all CTAs and per rank of the cluster; the cluster each takes
    (``cluster_report``)."""
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.ops import admm
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
        polish_select,
        ruiz_admm_all_rounds,
        solve_box_qp_fused,
    )
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    cfg = MPCConfig(T=LONG_T, dt=LONG_DT)
    _, k1_args = long_inputs(dev, cfg)
    kw = solver_kw(cfg)
    qp_k = build_qp(*k1_args)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    cold = solve_box_qp_batched(*qp, **kw)
    warm = (cold.x, cold.y, cold.rho)
    ab1 = ruiz_admm_all_rounds(*qp, warm=warm, **kw)
    n, m = qp[1].shape[1], qp[3].shape[1]
    times = {
        "k2_cold_ms": cuda_spread(lambda: solve_box_qp_fused(*qp, **kw), 5, 2),
        "k2_warm_ms": cuda_spread(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 5, 2),
        "ab1_warm_ms": cuda_spread(lambda: ruiz_admm_all_rounds(*qp, warm=warm, **kw), 5, 2),
        "ab2_warm_ms": cuda_spread(lambda: polish_select(*qp, ab1), 5, 2),
        "k2_warm_active_rows": active_rows(solve_box_qp_fused(*qp, warm=warm, **kw)),
        "ab2_active_rows": active_rows(polish_select(*qp, ab1))}
    # the cluster sizes past the smallest that fits (``cluster_size`` picks
    # the smallest), through the wrappers' forced launches
    kw_full = dict(kw)
    rho0 = kw_full.pop("rho0")
    for C in range(admm.cluster_size(admm.K2, n, m) + 1, admm.MAX_CLUSTER + 1):
        times[f"k2_warm_ms_on_{C}"] = cuda_spread(
            lambda: admm._launch_k2(C, *qp, rho0, warm, **kw_full), 5, 2)
    for C in range(admm.cluster_size(admm.AB1, n, m) + 1, admm.MAX_CLUSTER + 1):
        times[f"ab1_warm_ms_on_{C}"] = cuda_spread(
            lambda: admm._launch_ab1(C, *qp, rho0, warm, **kw_full), 5, 2)
    times["split"] = {}
    for name, solve, kernel in (("A/B-1", ruiz_admm_all_rounds, admm.AB1),
                                ("K2", solve_box_qp_fused, admm.K2)):
        C = admm.cluster_size(kernel, n, m)
        for start in ("warm", "cold"):
            times["split"][f"{name} {start}"] = section_split(
                "admm.cu", lambda: solve(*qp, **({"warm": warm} if start == "warm" else {}), **kw),
                qp[1].shape[0] * C, stamped_admm_source, ranks=C)
    C = admm.cluster_size(admm.AB2, n, m)
    times["split"]["A/B-2 on A/B-1's warm output"] = section_split(
        "admm.cu", lambda: polish_select(*qp, ab1), qp[1].shape[0] * C, stamped_admm_source,
        ranks=C)
    times["kernels"] = cluster_report(n, m)
    # the polish's active rows past T=40: K2 cold on the first LONG48_B rows
    for horizon in (LONG48_T, 60):
        c = MPCConfig(T=horizon, dt=LONG_DT)
        q = build_qp(*long_inputs(dev, c, LONG48_B)[1])
        times[f"k2_cold_active_rows_T{horizon}"] = active_rows(
            solve_box_qp_fused(q.P, q.q, q.G, q.lo, q.hi, **solver_kw(c)))
    return {f"n={n},m={m}": times}


# ``--solve-times``' barrier cycles (``cluster_sync_cycles``): the cycles of
# one barrier, a loop of 1000 of them in each of 8 CTAs (clusters of C),
# thread 0's clock64() over the loop.
CLUSTER_SYNC_SRC = r"""
#include <cooperative_groups.h>
#include <cstdio>
namespace cg = cooperative_groups;
__global__ void k_sync(long long* out, int iters) {  // __syncthreads()
  __shared__ float v[256];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) { v[threadIdx.x] += 1.f; __syncthreads(); }
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[blockIdx.x] = (t1 - t0) / iters + (long long)(v[0] * 0.f);
}
__global__ void k_cluster(long long* out, int iters) {  // cluster barrier
  __shared__ float v[256];
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) { v[threadIdx.x] += 1.f; cl.sync(); }
  const long long t1 = clock64();
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = (t1 - t0) / iters + (long long)(v[0] * 0.f);
}
__global__ void k_push(long long* out, int iters) {  // a float a thread to every rank, then the barrier
  __shared__ float v[256 * 4];
  cg::cluster_group cl = cg::this_cluster();
  const int C = cl.num_blocks(), r = cl.block_rank();
  v[threadIdx.x] = 0.f;
  cl.sync();
  const long long t0 = clock64();
  float acc = 0.f;
  for (int i = 0; i < iters; ++i) {
    acc += v[(threadIdx.x + i) & 255];
    for (int q = 0; q < C; ++q) cl.map_shared_rank(v, q)[256 * (r & 3) + threadIdx.x] = acc;
    cl.sync();
  }
  const long long t1 = clock64();
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = (t1 - t0) / iters + (long long)(acc * 0.f);
}
template <typename K>
long long run(K kern, int C) {
  long long* d;
  cudaMalloc(&d, sizeof(long long) * 32);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = C;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * 8);
  cfg.blockDim = dim3(256);
  cfg.attrs = a;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, d, 1000);
  long long h = -1;
  if (cudaDeviceSynchronize() == cudaSuccess) cudaMemcpy(&h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return h;
}
int main() {
  for (int C = 1; C <= 4; ++C)
    printf("%d %lld %lld %lld\n", C, run(k_sync, C), run(k_cluster, C), run(k_push, C));
  return 0;
}
"""


def cluster_sync_cycles():
    """{"C=1": ..., "C=4": ...}: the cycles one barrier takes
    (``CLUSTER_SYNC_SRC``, built with nvcc into ``_build/``) at clusters of
    C = 1-4 CTAs of 256 threads: __syncthreads(), a cluster barrier
    (arrive.release, wait.acquire), and a cluster barrier after each thread
    writes one float into every rank's shared memory."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, exe = _build.BUILD_DIR / "cluster_sync.cu", _build.BUILD_DIR / "cluster_sync"
    cu.write_text(CLUSTER_SYNC_SRC)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", str(cu), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    rows = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.split("\n")
    out = {}
    for row in filter(None, rows):
        C, sync, cluster, push = map(int, row.split())
        out[f"C={C}"] = {"syncthreads_cycles": sync, "cluster_barrier_cycles": cluster,
                         "push_and_cluster_barrier_cycles": push}
    return out


# clock64() section split of a kernel (``--k1k4-times``): thread 0 of every
# CTA reads the clock at the start of the kernel's body, after each of its
# top-level barriers and, after one more barrier, at its end.
SPLIT_SECTIONS = 16
SPLIT_MAX_CTAS = 65536
_SPLIT_MACRO = ("#define KS_STAMP(i) if (threadIdx.x == 0) { const long long t_ = clock64(); "
                "ks_acc[i] = t_ - ks_last; ks_last = t_; }\n"
                f"__device__ long long ks_split[{SPLIT_MAX_CTAS} * {SPLIT_SECTIONS}];\n")
_SPLIT_READ = ('extern "C" int ks_split_read(long long* out, int n) {\n'
               "  return (int)cudaMemcpyFromSymbol(out, ks_split, sizeof(long long) * n);\n}\n")


_SPLIT_LIBS = {}   # source name -> its stamped library, built once a process


def stamped_source(src: str):
    """(source, section names): ``src`` with the clock reads in its first
    ``__global__`` function (its body's top-level ``  __syncthreads();``
    lines and its closing ``}`` line are the anchors) and ``ks_split_read``,
    which copies each CTA's cycles per section out."""
    lines = src.splitlines()
    first = next(i for i, ln in enumerate(lines) if "__global__" in ln)
    body = next(i for i in range(first, len(lines)) if lines[i].rstrip().endswith("{"))
    end = next(i for i in range(body + 1, len(lines)) if lines[i] == "}")
    out, names = [], []
    for i, line in enumerate(lines):
        if line.startswith("namespace {"):
            out.append(_SPLIT_MACRO)
        if i == end:
            names.append(f"to the end (line {i + 1})")
            out += ["  __syncthreads();", f"  KS_STAMP({len(names) - 1});",
                    "  if (threadIdx.x == 0)",
                    f"    for (int s_ = 0; s_ < {SPLIT_SECTIONS}; ++s_)",
                    f"      ks_split[(blockIdx.y * gridDim.x + blockIdx.x) * {SPLIT_SECTIONS} + s_]"
                    " = ks_acc[s_];"]
        out.append(line)
        if i == body:
            out.append(f"  long long ks_acc[{SPLIT_SECTIONS}] = {{}};\n"
                       "  long long ks_last = clock64();")
        elif body < i < end and line == "  __syncthreads();":
            names.append(f"to the barrier at line {i + 1}")
            out.append(f"  KS_STAMP({len(names) - 1});")
    check(len(names) <= SPLIT_SECTIONS, f"split: {len(names)} sections > {SPLIT_SECTIONS}")
    return "\n".join(out) + "\n" + _SPLIT_READ, names


# The ADMM phase's split (``--solve-times``): K2's and A/B-1's bodies have
# no top-level barrier, and the phase runs inside ``ruiz_admm``, so thread 0
# adds the cycles since its previous read to a section's total at these
# source lines (the same lines in every version since the two-launch split,
# but for the call of ruiz_admm, a template since the quad placement).
# (section, anchor lines, stamp "before" or "after" it, where: the kernels'
# bodies or anywhere). The polish's anchors: its start, the inverse of P's
# factor, the objective's first line, the Schur factor's call and the
# accept test's first line, on one CTA and on a cluster.
POLISH_START = "  // ---- polish: factor P once (Lp in M, Y = Lp^-1) ----"
POLISH_INVERSE = ("  tri_inverse(s.M, s.Y, n, ld);", "  tri_inverse_cols(s.M, s.Y, n, ld);",
                  "  tri_inverse_upper(s.M, s.ydiag, n, s.ldn);")
POLISH_OBJECTIVE = "  float acc[2] = {0.f, 0.f};              // x'Px, q'x"
POLISH_CHOL_S = ("  chol_inplace(s.S, a, ldm);", "  chol_steps(s.S, a, ldm);", "    chol_rows(S, a);")
POLISH_ACCEPT = "  float mxv[2] = {-INFINITY, 0.f};  // violation, non-finite flag"
ADMM_SPLIT = (
    ("load", ("  load_problem(s, Pg, Gg, qg, log_, hig, b);",
              "    load_problem(s, Pg, Gg, qg, log_, hig, b);",
              "  load_split(s, Pg, Gg, qg, log_, hig, b);",
              "  polish_start(s, sm, Pg, Gg, qg, log_, hig, n, m, b);",
              "  polish_start(w, sm, Pg, Gg, qg, log_, hig, n, m, b);"), "after", "kernels"),
    ("Ruiz", "  // ---- scaled problem, warm start ----", "before", "any"),
    ("scaled problem, z start, G'G", "  // ---- adaptive ADMM ----", "before", "any"),
    ("residual checks", ("    if (refac) factorize(s, rho, p.sigma);",
                         "    if (refac) factorize_split(s, rho, p.sigma);"), "before", "any"),
    ("factorizations", ("    if (refac) factorize(s, rho, p.sigma);",
                        "    if (refac) factorize_split(s, rho, p.sigma);"), "after", "any"),
    ("iterations", ("    admm_iterate(a, rho, p.check_iters, p.sigma, p.alpha);",
                    "    admm_iterate_split<Bk>(s, rho, p.check_iters, p.sigma, p.alpha);"), "after",
     "any"),
    ("residual checks", "  // ---- unscale: x and y of the original problem ----", "before", "any"),
    ("unscale", ("  const AdmmOut a = ruiz_admm(s, p, xw, yw, rho_w, b);",
                 "  const AdmmOut a = ruiz_admm<Bk>(s, p, xw, yw, rho_w, b);",
                 "    const AdmmOut a = ruiz_admm<Bk>(s, p, xw, yw, rho_w, b);",
                 "  const AdmmOut a = ruiz_admm_split<Bk>(s, p, xw, yw, rho_w, b);"), "after",
     "kernels"),
    # the polish (K2 after the unscale, A/B-2 after its load): what precedes
    # P's factorization (K2 on a cluster: y gathered, the polish's load)
    # counts as load
    ("load", POLISH_START, "before", "any"),
    ("polish: P's Cholesky", POLISH_INVERSE, "before", "any"),
    ("polish: P's inverse", POLISH_OBJECTIVE, "before", "any"),
    ("polish: objective and Gx", "  // attempt 1: the active set named by the ADMM duals", "before",
     "any"),
    ("polish: Vt_a and S_aa", POLISH_CHOL_S, "before", "any"),
    ("polish: chol(S_aa)", POLISH_CHOL_S, "after", "any"),
    ("polish: KKT solves, refinement", POLISH_ACCEPT, "before", "any"),
    # the attempt's checks, and between the attempts the second set's choice
    ("polish: accept checks", ("  return mxv[1] == 0.f && mxv[0] <= 1e-5f * span &&",
                               "  return ok != 0.f;  // the same on every rank",
                               "  // branchless-equivalent select and the primal residual of the "
                               "returned x"), "before", "any"),
)
# the kernels stamped: K2 and A/B-1 on one CTA and on a cluster (every rank
# of a cluster reads its own clock; the cluster kernels end on a cluster
# barrier, so a partner's last section holds its wait for rank 0)
ADMM_SPLIT_KERNELS = ("solve_polish_kernel(", "ruiz_admm_kernel(", "solve_polish_cluster_kernel(",
                      "ruiz_admm_cluster_kernel(", "polish_select_kernel(",
                      "polish_select_cluster_kernel(")
STAMP_RESERVE = 1024   # bytes of a rank the stamped copy keeps for its counters
_ADMM_STAMP = ("__shared__ long long ks_acc[{n}], ks_last;\n"
               "#define KS_STAMP(i) if (threadIdx.x == 0) {{ const long long t_ = clock64(); "
               "ks_acc[i] += t_ - ks_last; ks_last = t_; }}\n"
               "__device__ long long ks_split[{ctas} * {n}];\n")


def _alternatives(anchor):
    return (anchor,) if isinstance(anchor, str) else anchor


def stamped_admm_source(src: str):
    """(source, section names): ``src`` (``csrc/admm.cu``) with thread 0's
    clock reads at the ``ADMM_SPLIT`` lines of K2 and A/B-1 and at their
    closing ``}`` (the store, and for K2 the polish), accumulated per
    section, and ``ks_split_read``."""
    # the counters are static shared memory: the cluster layouts, which may
    # take a rank's whole RANK_BYTES, leave them room in this copy
    src = src.replace("constexpr size_t RANK_BYTES = 232448;",
                      f"constexpr size_t RANK_BYTES = 232448 - {STAMP_RESERVE};")
    lines = src.splitlines()
    names = list(dict.fromkeys(s[0] for s in ADMM_SPLIT)) + [
        "store (A/B-1); polish: select, store (K2, A/B-2)"]
    check(len(names) <= SPLIT_SECTIONS, f"split: {len(names)} sections > {SPLIT_SECTIONS}")
    spans = []
    for head in ADMM_SPLIT_KERNELS:
        first = next((i for i, ln in enumerate(lines) if ln.startswith(head)), None)
        if first is None:   # a version without cluster kernels
            continue
        spans.append((first, next(i for i in range(first, len(lines)) if lines[i] == "}")))
    out, hits = [], {}
    for i, line in enumerate(lines):
        kernel = next((s for s in spans if s[0] <= i <= s[1]), None)
        if line.startswith("namespace {"):
            out.append(_ADMM_STAMP.format(n=SPLIT_SECTIONS, ctas=SPLIT_MAX_CTAS))
        if kernel and i == kernel[1]:
            out += ["  __syncthreads();", f"  KS_STAMP({len(names) - 1});",
                    "  if (threadIdx.x == 0)",
                    f"    for (int s_ = 0; s_ < {SPLIT_SECTIONS}; ++s_)",
                    f"      ks_split[blockIdx.x * {SPLIT_SECTIONS} + s_] = ks_acc[s_];"]
        stamps = [(names.index(name), when) for name, anchor, when, where in ADMM_SPLIT
                  if line in _alternatives(anchor) and (where == "any" or kernel)]
        out += [f"  KS_STAMP({k});" for k, when in stamps if when == "before"]
        out.append(line)
        out += [f"  KS_STAMP({k});" for k, when in stamps if when == "after"]
        if kernel and line == "  extern __shared__ float sm[];":
            out.append("  if (threadIdx.x == 0) { for (int s_ = 0; s_ < "
                       f"{SPLIT_SECTIONS}; ++s_) ks_acc[s_] = 0; ks_last = clock64(); }}")
        for _, anchor, _, _ in ADMM_SPLIT:
            if line in _alternatives(anchor):
                hits[anchor] = hits.get(anchor, 0) + 1
    missing = [a[1] for a in ADMM_SPLIT if a[1] not in hits]
    check(not missing, f"split: anchors not found: {missing}")
    return "\n".join(out) + "\n" + _SPLIT_READ, names


def section_split(source_name, run, n_ctas, stamp=stamped_source, ranks=1):
    """Build the package's ``csrc/<source_name>`` with the clock reads of
    ``stamp`` into ``_build/`` alone, call ``run`` (which launches the
    kernel through the package's wrapper) with that library in place of
    the package's, and return each section's mean cycles per CTA and its
    share, with the stamped copy's time. With ``ranks`` > 1 (a cluster of
    that many CTAs a scenario, grid ``n_ctas``, rank blockIdx.x mod
    ``ranks``) also each rank's own mean under ``ranks``."""
    import ctypes

    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    check(n_ctas <= SPLIT_MAX_CTAS, f"split: {n_ctas} CTAs > {SPLIT_MAX_CTAS}")
    src, names = stamp((_build.CSRC_DIR / source_name).read_text())
    if source_name not in _SPLIT_LIBS:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = source_name.replace(".cu", "_split")
        cu, so = _build.BUILD_DIR / f"{stem}.cu", _build.BUILD_DIR / f"lib{stem}.so"
        cu.write_text(src)
        build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                                *_build.SOURCE_FLAGS.get(source_name, ()), "-shared", str(cu),
                                "-o", str(so)], capture_output=True, text=True)
        check(build.returncode == 0, f"split: nvcc failed on {cu.name}:\n{build.stderr[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
        lib.ks_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _SPLIT_LIBS[source_name] = lib
    lib = _SPLIT_LIBS[source_name]
    base = _build.load()

    class Overlay:
        def __getattr__(self, name):
            return getattr(lib if hasattr(lib, name) else base, name)

    load = _build.load
    _build.load = Overlay
    try:
        ms = cuda_ms(run, 10)
        run()
        torch.cuda.synchronize()
    finally:
        _build.load = load
    acc = np.zeros(n_ctas * SPLIT_SECTIONS, np.int64)
    check(lib.ks_split_read(acc.ctypes.data, acc.size) == 0, "split: reading the stamps failed")
    per_cta = acc.reshape(n_ctas, SPLIT_SECTIONS)[:, :len(names)].astype(np.float64)

    def summary(cycles):
        return {"cycles_per_cta": float(cycles.sum()),
                "sections": {name: {"cycles": float(c), "share": float(c / cycles.sum())}
                             for name, c in zip(names, cycles)}}

    out = {"stamped_ms": ms, **summary(per_cta.mean(0))}
    if ranks > 1:
        by_rank = per_cta.reshape(n_ctas // ranks, ranks, -1)
        out["ranks"] = [summary(by_rank[:, r].mean(0)) for r in range(ranks)]
    return out


def cuda_spread(fn, groups, per_group=10):
    """(median, min, max) over ``groups`` of the device ms per call of
    ``fn``, each group ``per_group`` calls back to back between two CUDA
    events (no host gap between the calls)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return float(np.median(times)), float(min(times)), float(max(times))


def k4_warp_steps(ep, packed):
    """Counts (not measurements) behind K4's issue on these poses: the rows
    the points need (``rows_tested``), and the row steps a warp runs when
    it steps all its lanes through an obstacle until its last point leaves
    it: over a warp of one pose's points (the kernel since the live table)
    and over 32 consecutive (row, point) tasks of a block of 8 rows (the
    one-point-a-thread kernel before it). None where the package has no
    ``rows_needed``; the counts depend on the data alone."""
    from mpc_for_av_at_intersection_tpu_torch.ops import collision

    if not hasattr(collision, "rows_needed"):
        return None
    F, PC = ep.shape[1], packed.cc.shape[0]
    pose_steps = item_steps = point_rows = 0
    for _, need in collision.rows_needed(ep, packed):                  # (b, F, PC, O)
        b, O = need.shape[0], need.shape[-1]
        point_rows += int(need.sum())
        pose_steps += int(need.amax(dim=2).sum())
        blocks = torch.nn.functional.pad(need, (0, 0, 0, 0, 0, -F % 8)).reshape(b, -1, 8 * PC, O)
        blocks = torch.nn.functional.pad(blocks, (0, 0, 0, -(8 * PC) % 32))
        item_steps += int(blocks.reshape(b, blocks.shape[1], -1, 32, O).amax(dim=3).sum())
    return {"point_rows": point_rows, "warp_steps_pose_warps": pose_steps,
            "warp_steps_32_task_warps": item_steps,
            "point_rows_per_warp_step_pose_warps": point_rows / max(pose_steps, 1),
            "point_rows_per_warp_step_32_task_warps": point_rows / max(item_steps, 1)}


def beam_iteration_input(dev, it):
    """The frontier poses of beam iteration ``it`` on phase 11's 1024
    sampled geometries, and the search's packed geometry."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import wavefront
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry

    scen = sampled_junctions(GEOM_B)
    _, cfg = wavefront.grid_for(scen, "beam")
    real, seen = wavefront.frontier_collision, {"calls": 0}

    def recording(ep, packed):
        if seen["calls"] == it:
            seen["ep"], seen["packed"] = ep.clone(), packed
        seen["calls"] += 1
        return real(ep, packed)

    wavefront.frontier_collision = recording
    try:
        wavefront.plan_courses_device(scen, bicycle_geometry(), cfg=cfg, engine="beam", device=dev)
    finally:
        wavefront.frontier_collision = real
    return seen["ep"], seen["packed"]


def main_k1k4_times() -> int:
    """``--k1k4-times``: one JSON line of K1 and K4 on the card: CUDA-event
    medians (with the least and most) over 20 groups of 10 calls of K1, canonical
    and jerk, on the headline generator's inputs at B=4096, T=20 and at the
    fleet's B=1024, T=13 (the first 1024 rows), and of K4 on phase 10's
    iteration-26 input; each kernel's CTAs per SM, registers and spills;
    the clock64() section split of each (``section_split``); digests of
    each K1 output field; and K4's row and warp-step counts
    (``k4_warp_steps``). Run it with two checkouts' packages in one call
    to compare them on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
    from mpc_for_av_at_intersection_tpu_torch.ops import collision
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    result = {"card": smi.stdout.strip().splitlines()[0], "k1": {}}
    for rows, horizon in ((B, T), (FLEET_B, 13)):
        inputs, oa, od, ref = headline_inputs(dev, horizon)
        for jerk in (False, True):
            cfg = dataclasses.replace(MPCConfig.with_jerk(), T=horizon) if jerk else MPCConfig(T=horizon)
            args = tuple(a[:rows] if isinstance(a, torch.Tensor) else a
                         for a in k1_inputs(inputs, oa, od, ref, cfg))

            def run():
                return build_qp(*args)

            ms, lo, hi = cuda_spread(run, 20)
            out = run()
            result["k1"][f"B={rows},T={horizon},{'jerk' if jerk else 'canonical'}"] = {
                "ms": ms, "min_ms": lo, "max_ms": hi, "bound_ms": k1_bound(rows, horizon, jerk)[0],
                "kernel": k1_kernel_report(horizon, jerk),
                "split": section_split("condense_qp.cu", run, rows),
                "digests": {name: _digest([getattr(out, name)]) for name in out._fields}}
        del inputs, oa, od, ref
        torch.cuda.empty_cache()
    ep, packed = beam_iteration_input(dev, 26)
    torch.cuda.empty_cache()

    def run4():
        return collision.frontier_collision(ep, packed)

    ms, lo, hi = cuda_spread(run4, 20)
    import re

    from mpc_for_av_at_intersection_tpu_torch.ops import _build

    Bk, F, _ = ep.shape
    rows = int(re.search(r"K4_ROWS = (\d+);", (_build.CSRC_DIR / "collision.cu").read_text())[1])
    n_ctas = Bk * -(-F // rows)
    result["k4"] = {"ms": ms, "min_ms": lo, "max_ms": hi, "shape": [Bk, F, packed.n_prims],
                    "bound_ms": k4_bound(ep, packed, collision.rows_tested(ep, packed))[0],
                    "kernel": k4_kernel_report(packed.cc.shape[0]),
                    "split": section_split("collision.cu", run4, n_ctas),
                    "flags_digest": _digest([run4()]), "counts": k4_warp_steps(ep, packed)}
    print(json.dumps(result))
    return 0


SCAN_ME_S, SCAN_FLEET_B = 1024, 10000   # the benchmark cells' fleets: 8,192 and 10,000 rows
SCAN_TICKS = 3                           # chained ticks before the scan's inputs are taken


def scan_inputs(dev, cell, ticks=SCAN_TICKS):
    """The conflict scan's arguments in each of ``ticks`` chained ticks of
    a benchmark cell's shape: ``multi_ego``, SCAN_ME_S copies of the 8-ego
    junction with the egos moved by N(0, 0.2) m, or ``fleet``, SCAN_FLEET_B
    standard junctions (0-2 scripted cars in 4 slots)."""
    from mpc_for_av_at_intersection_tpu_torch import api
    from mpc_for_av_at_intersection_tpu_torch.engine import (
        EngineConfig,
        closed_loop,
        engine_tick_fleet,
        multi_ego_fleet_tick,
    )

    if cell == "multi_ego":
        world, st0, cfg, geom = eight_ego_junction(dev)
        world, st = junction_copies(world, SCAN_ME_S), junction_copies(st0, SCAN_ME_S)
        noise = np.random.default_rng(SEED).normal(0, 0.2, st.egos.shape[:-1] + (2,))
        st = st._replace(egos=torch.cat([st.egos[..., :2] + torch.tensor(
            noise, dtype=torch.float32, device=dev), st.egos[..., 2:]], -1))
        tick = lambda x: multi_ego_fleet_tick(world, x, cfg, geom)   # noqa: E731
    else:
        cfg = EngineConfig()
        geom, world, st, _ = api.sample_intersection_fleet_batched(
            SCAN_FLEET_B, np.random.default_rng(SEED), cfg=cfg, n_steps=128, planner="native",
            device=dev)
        tick = lambda x: engine_tick_fleet(world, x, cfg, geom)   # noqa: E731
    scan, taken = closed_loop.check_collision_moving_cars, []

    def take(*args):
        taken.append(tuple(a.contiguous() if torch.is_tensor(a) else a for a in args))
        return scan(*args)

    closed_loop.check_collision_moving_cars = take
    try:
        for _ in range(ticks):
            st, _ = tick(st)
    finally:
        closed_loop.check_collision_moving_cars = scan
    return taken


def scan_bound(args, frames):
    """The scan kernel's bound on these inputs: its inputs (poses, the
    headings' cosines and sines, lengths, masks) read once and its outputs
    written once; 6 operations (two differences, two products, a sum, a
    compare) a pair test of the frames the rows walked, every (ego circle,
    active obstacle, shift, obstacle circle) pair of each."""
    ego, n_ego, det, n_det, obs, active, centers, _, fw, _ = args
    n_c = centers.shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in (ego, n_ego, det, n_det, obs, active,
                                                        centers))
    nbytes += 8 * (ego[..., 2].numel() + det[..., 2].numel() + obs[..., 2].numel())
    nbytes += ego.shape[0] * (1 + 8 + 4 + 4)
    pairs = float((frames.double() * active.sum(1).double()).sum()) * n_c * n_c * (2 * fw + 1)
    return _bound(nbytes, 6 * pairs), pairs


def main_scan_times() -> int:
    """``--scan-times``: one JSON line of the conflict scan on the card at
    both benchmark cells' shapes (``scan_inputs``): the kernel's device time
    (``scan_kernel`` in a profile of 20 calls), the wrapper's CUDA-event
    median (with the least and most) over 20 groups of 10 calls (the kernel
    and the headings' six cosine and sine launches), the plain torch scan's
    over 3 groups of 2; the outputs bit for bit the plain scan's and the
    frames walked its count; the frames a row walked, the share of rows
    with a hit, the bound (``scan_bound``), registers and spills."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from mpc_for_av_at_intersection_tpu_torch.agents import collision
    from mpc_for_av_at_intersection_tpu_torch.ops import scan

    dev = torch.device("cuda", 0)
    result = {"card": nvidia_smi_line()}
    for cell in ("multi_ego", "fleet"):
        args = scan_inputs(dev, cell)[-1]
        ego, n_ego, _, _, obs, active, centers, radius, fw, n_frames = args
        kern = scan.first_hit_scan(*args)
        plain = collision.check_collision_moving_cars_reference(*args)
        walked = collision.frames_walked(ego, n_ego, obs, active, centers, radius, fw, n_frames)
        equal = {name: same_bits(getattr(kern, name), getattr(plain, name))
                 for name in plain._fields}
        equal["frames"] = bool(torch.equal(kern.frames, walked))
        check(all(equal.values()), f"scan kernel at the {cell} shape: equal {equal}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                scan.first_hit_scan(*args)
            torch.cuda.synchronize()
        kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "scan_kernel" in e.key) / 20
        ms, lo, hi = cuda_spread(lambda: scan.first_hit_scan(*args), 20)
        plain_ms, plain_lo, plain_hi = cuda_spread(
            lambda: collision.check_collision_moving_cars_reference(*args), 3, per_group=2)
        (bound_ms, by), pairs = scan_bound(args, kern.frames)
        u = _usage("scan_kernel")
        result[cell] = {
            "rows": ego.shape[0], "obstacle_slots": obs.shape[1],
            "launch_shape": scan.launch_shape(obs.shape[1], centers.shape[0], fw, obs.shape[2],
                                              n_frames),
            "kernel_ms": kernel_us / 1e3, "wrapper_ms": ms, "wrapper_min_ms": lo,
            "wrapper_max_ms": hi, "plain_ms": plain_ms, "plain_min_ms": plain_lo,
            "plain_max_ms": plain_hi, "bound_ms": bound_ms, "bound_by": by, "pairs": pairs,
            "frames_per_row": float(kern.frames.double().mean()),
            "found_share": float(kern.found.double().mean()),
            "active_per_row": float(active.sum(1).double().mean()), "equal": equal,
            "registers": u.get("regs"), "stack": u.get("stack"), "spill": u.get("spill")}
        print(f"scan at the {cell} shape: {result[cell]}", flush=True)
        del args, kern, plain
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    modes = {"--digests": main_digests, "--solve-times": main_solve_times,
             "--astar-times": main_astar_times, "--k1k4-times": main_k1k4_times,
             "--long-horizon": main_long_horizon, "--fleets": main_fleets,
             "--long-horizon-numerics": main_long_numerics, "--tail-sample": main_tail_sample,
             "--scan-times": main_scan_times}
    sys.exit(modes.get(" ".join(sys.argv[1:]), main)())
