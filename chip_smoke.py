#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``mpc_for_av_at_intersection_tpu_torch/csrc``,
checks each against its plain PyTorch version on the card, then drives the
batched controller tick (``mpc_step_batched``) closed loop through the plant
at the size of the repo's headline benchmark (B=4096 scenarios, horizon
T=20, N=512-point courses) and checks the kernels carried it.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with each kernel's launches,
error and time, the card's name and power limit as nvidia-smi reports them,
and finally ``{"ok": true, "device": {...}}``. Exits non-zero, without that
last line, when no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
B, T, N = 4096, 20, 512          # bench.py:18-20
DL = 0.083                       # course tick [m]
N_WARM = 20                      # warm ticks after the cold one
CPU_ROWS = 512                   # rows re-run on the CPU plain path
K1_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/condense_qp.cu"
K2_SOURCE = "mpc_for_av_at_intersection_tpu_torch/csrc/admm.cu"
K1_REPLACES = "mpc_for_av_at_intersection_tpu/ops/condense_pallas.py:35"
K2_REPLACES = "mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:835"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_inputs(seed):
    """Course/state generator of bench.py:57-75."""
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
    oa = rng.normal(0.0, 1.0, size=(B, T))     # previous controls for K1's rollout
    od = rng.normal(0.0, 0.2, size=(B, T))
    return state, course, oa, od


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


def compare_solutions(kern, plain, x_true, cert, tag):
    """The kernel must solve the QPs at least as well as the plain version.

    At B=4096, T=20 the condensed Hessian's condition number reaches ~1e7,
    so in float32 x is fixed only up to directions of near-zero curvature,
    and two correct float32 solvers (the plain version on the CPU and on
    the card among them) differ by far more than the 5e-4 / 2e-2 bars of
    tests/test_batched_solver.py:47-57. Both are therefore held to the
    float64 optimum on the rows it certifies: the kernel's error quantiles
    may not exceed 1.5x the plain version's (+1e-5), nor may it have more
    rows off by > 2e-2 (+1% of rows). The polished count must reach plain's
    minus rows/32, and the solved share 98%.
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
    print(f"K2 {tag}: error vs float64 optimum ({int(cert.sum())} certified rows) p50/p90/p99 "
          f"kernel {qk[0]:.3g}/{qk[1]:.3g}/{qk[2]:.3g}, plain {qp_[0]:.3g}/{qp_[1]:.3g}/"
          f"{qp_[2]:.3g}; rows > 2e-2 kernel {tail_k} plain {tail_p}; polished kernel {n_kern} "
          f"plain {n_plain}; solved {share:.4f}; kernel vs plain max|dx| where both polished "
          f"{err_both:.3g}; checks mean kernel {float(kern.checks.mean()):.3f} "
          f"plain {float(plain.checks.mean()):.3f}")
    check(int(cert.sum()) >= 0.95 * rows, f"K2 {tag}: float64 optimum certified on {int(cert.sum())} rows")
    for p, a, b in zip((50, 90, 99), qk, qp_):
        check(a <= 1.5 * b + 1e-5, f"K2 {tag}: p{p} error {a} > 1.5 x plain {b}")
    check(tail_k <= tail_p + rows // 100, f"K2 {tag}: {tail_k} rows off by > 2e-2, plain {tail_p}")
    check(n_kern >= n_plain - rows // 32, f"K2 {tag}: polished {n_kern} < plain {n_plain} - B/32")
    check(share >= 0.98, f"K2 {tag}: solved share {share}")
    return err_both


def controls(out, rows=slice(None)):
    """(rows, 2) float64 accel/steer on the CPU."""
    return torch.stack([out.accel[rows].cpu(), out.steer[rows].cpu()], dim=1).double()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2

    from mpc_for_av_at_intersection_tpu_torch.core import SimLimits, plant_step
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.mpc import (
        MPCConfig,
        controller_state_from_numpy,
        controller_state_to_numpy,
        init_controller_state,
    )
    from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
    from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
    from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
    from mpc_for_av_at_intersection_tpu_torch.ops import _build
    from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
    from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

    # full float32 in every matmul of the plain versions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f32 = torch.float32

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi_line}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s -> {lib_path.name}; ptxas: {' | '.join(ptxas)}")

    # ---- 3. inputs ----
    state_np, course_np, oa_np, od_np = bench_inputs(SEED)
    states0 = torch.tensor(state_np, dtype=f32, device=dev)
    courses = torch.tensor(course_np, dtype=f32, device=dev)
    speeds = torch.zeros((B, N), dtype=f32, device=dev)
    valid = torch.full((B,), N, dtype=torch.int32, device=dev)
    dls = torch.full((B,), DL, dtype=f32, device=dev)
    cfg = MPCConfig(T=T)
    wheelbase = bicycle_geometry().wheelbase
    print(f"inputs: seed {SEED}, B={B}, T={T}, N={N}")

    # ---- 4. K1 vs plain ----
    oa = torch.tensor(oa_np, dtype=f32, device=dev)
    od = torch.tensor(od_np, dtype=f32, device=dev)
    cs0 = init_controller_state(cfg, device=dev, batch=B)
    ref = compute_reference(states0, courses, speeds, valid, dls, cs0.target_idx, cs0.ov,
                            cs0.have_ov, T, cfg.dt)
    k1_args = (states0, oa, od, ref.xref, ref.reaches_end, cfg, wheelbase)
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

    # ---- 5. K2 vs plain, cold then warm, both held to the float64 optimum ----
    checks, iters, eps, band, cap, ratio = cfg.solver_schedule
    kw = dict(rounds=checks, iters=iters, rho0=cfg.admm_rho, sigma=cfg.admm_sigma,
              alpha=cfg.admm_alpha, eps=eps, refactor_band=band, stall_cap=cap,
              stall_ratio=ratio, ruiz_iters=cfg.admm_ruiz_iters)
    qp = (qp_k.P, qp_k.q, qp_k.G, qp_k.lo, qp_k.hi)
    x_true, cert = true_solution(qp)
    cold_k = solve_box_qp_fused(*qp, **kw)
    cold_p = solve_box_qp_batched(*qp, **kw)
    k2_err = compare_solutions(cold_k, cold_p, x_true, cert, "cold")
    warm = (cold_p.x, cold_p.y, cold_p.rho)
    warm_k = solve_box_qp_fused(*qp, warm=warm, **kw)
    warm_p = solve_box_qp_batched(*qp, warm=warm, **kw)
    k2_err = max(k2_err, compare_solutions(warm_k, warm_p, x_true, cert, "warm"))
    k2_cold_ms = cuda_ms(lambda: solve_box_qp_fused(*qp, **kw), 5)
    k2_cold_plain_ms = cuda_ms(lambda: solve_box_qp_batched(*qp, **kw), 2)
    k2_ms = cuda_ms(lambda: solve_box_qp_fused(*qp, warm=warm, **kw), 10)
    k2_plain_ms = cuda_ms(lambda: solve_box_qp_batched(*qp, warm=warm, **kw), 3)
    print(f"K2 time: cold kernel {k2_cold_ms:.3f} ms, plain {k2_cold_plain_ms:.3f} ms; "
          f"warm kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")

    # ---- 6. the slice, closed loop: 1 cold + N_WARM warm ticks ----
    limits = SimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                       min_speed=cfg.min_speed)
    states, cs = states0, cs0
    snap, outs, tick_ms, shares = {}, {}, [], []
    build_qp.launches = 0
    solve_box_qp_fused.launches = 0
    for tick in range(1 + N_WARM):
        if tick in (0, N_WARM):
            snap[tick] = (states[:CPU_ROWS].cpu(),
                          {k: v[:CPU_ROWS] for k, v in controller_state_to_numpy(cs).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_step_batched(states, courses, speeds, valid, dls, cs, cfg, wheelbase)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        shares.append(float(out.solved.float().mean()))
        check(shares[-1] >= 0.98, f"tick {tick}: solved share {shares[-1]}")
        if tick in (0, N_WARM):
            outs[tick] = out
        states = plant_step(states, torch.stack([out.accel, out.steer], dim=-1), cfg.dt,
                            wheelbase, limits)
        cs = out.state
    launches = {"build_qp": build_qp.launches, "solve_box_qp_fused": solve_box_qp_fused.launches}
    check(launches == {"build_qp": 1 + N_WARM, "solve_box_qp_fused": 1 + N_WARM},
          f"kernel launches over the loop: {launches}")
    check(bool(states.isfinite().all()), "plant states went non-finite")
    print(f"loop: {1 + N_WARM} ticks, launches {launches}, solved share min "
          f"{min(shares):.4f}, "
          f"cold tick {tick_ms[0]:.1f} ms")

    # The same rows on CPU tensors from the carried state: the plain path in
    # float32, and in float64 as the yardstick for the tail. The p95
    # bar of tests/test_batched_solver.py:361 (2e-3) holds against the
    # float32 plain path. Its max bar (2e-2) does not hold for float32 at
    # all on a cold tick: the float32 plain path itself is off the float64
    # tick by up to ~2 on a few rows (near-flat QP directions, see
    # compare_solutions). So the tail bar counts rows off the float64 tick
    # by > 2e-2: the kernel path may have no more of them than the float32
    # plain path, plus max(2, 1% of the rows).
    cpu = torch.device("cpu")
    sl = slice(0, CPU_ROWS)
    for tick, (st_cpu, cs_np) in snap.items():
        o = outs[tick]
        plain = {}
        for dt in (f32, torch.float64):
            cs_cpu = controller_state_from_numpy(cs_np, cpu)
            cs_cpu = cs_cpu._replace(**{k: v.to(dt) for k, v in cs_cpu._asdict().items()
                                        if v.is_floating_point()})
            plain[dt] = mpc_step_batched(st_cpu.to(dt), courses[sl].cpu().to(dt),
                                         speeds[sl].cpu().to(dt), valid[sl].cpu(),
                                         dls[sl].cpu().to(dt), cs_cpu, cfg, wheelbase)
        p32, p64 = plain[f32], plain[torch.float64]
        both = o.solved[sl].cpu() & p32.solved
        d32 = (controls(o, sl) - controls(p32)).abs()[both]
        p95 = float(d32.quantile(0.95, dim=0).max())
        mx = float(d32.max())
        all3 = both & p64.solved
        tail_k = int(((controls(o, sl) - controls(p64)).abs().amax(1) > 2e-2)[all3].sum())
        tail_p = int(((controls(p32) - controls(p64)).abs().amax(1) > 2e-2)[all3].sum())
        idx_eq = bool((o.target_idx[sl].cpu() == p32.target_idx).all())
        print(f"tick {tick} vs CPU plain ({CPU_ROWS} rows, {int(both.sum())} both solved): "
              f"controls p95 {p95:.3g} (bar 2e-3), max {mx:.3g}; rows off the float64 tick "
              f"by > 2e-2: kernel path {tail_k}, float32 plain {tail_p}; "
              f"target_idx equal {idx_eq}")
        check(idx_eq, f"tick {tick}: target_idx differs from the CPU plain path")
        check(int(both.sum()) >= 0.98 * CPU_ROWS, f"tick {tick}: too few rows solved by both")
        check(p95 < 2e-3, f"tick {tick}: controls p95 {p95}")
        check(tail_k <= tail_p + max(2, CPU_ROWS // 100),
              f"tick {tick}: {tail_k} rows off the float64 tick, float32 plain {tail_p}")

    # warm-tick time, kernel path vs plain path on the card, same state
    args = (states, courses, speeds, valid, dls, cs, cfg, wheelbase)
    loop_ms = float(np.median(tick_ms[1:]))
    kern_ms = float(np.median([_timed(lambda: mpc_step_batched(*args)) for _ in range(5)]))
    plain_ms = float(np.median([
        _timed(lambda: _mpc_step(*args, build_qp_reference, solve_box_qp_batched))
        for _ in range(3)]))
    print(f"warm tick: kernel path {loop_ms:.2f} ms median over the loop "
          f"({B / loop_ms * 1e3:.0f} solves/s), {kern_ms:.2f} ms on the final state; "
          f"plain path {plain_ms:.2f} ms ({B / plain_ms * 1e3:.0f} solves/s)")

    print(json.dumps({"kernels": [
        {"name": "build_qp", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": launches["build_qp"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "solve_box_qp_fused", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["solve_box_qp_fused"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


if __name__ == "__main__":
    sys.exit(main())
