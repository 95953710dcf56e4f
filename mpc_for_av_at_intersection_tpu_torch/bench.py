"""Benchmark: batched MPC solves/s per card at the N=20 bicycle horizon.

Port of the repository root's ``bench.py`` (a JAX script, which the JAX
CLI's ``bench`` runs). One "solve" is a full controller tick — course
localization, velocity-lookahead reference, nonlinear operating rollout,
linearization, condensing, ADMM + polish (``mpc_step_batched``: K1 and K2)
— what the reference does per tick through CVXPY/ECOS. Same sizes and
metric names as the original: B=4096 scenarios, T=20, N=512-point courses,
20 warm-started steady ticks after a cold one
(``mpc_solves_per_sec_per_chip_T20``), then 1024 sampled intersections x 32
ticks through ``run_batch_episodes`` (``fleet_scenario_ticks_per_s``; set
``BENCH_FLEET=0`` to skip it). Each bracket ends in
``torch.cuda.synchronize()`` (a value fetch for the fleet, as the original).

The original's ``vs_baseline`` divides by a TPU target and is left out.
Prints ONE JSON line on stdout; on stderr the batch, the times, the seed
(entropy-drawn, so every run can be replayed) and the card's name and power
limit as ``nvidia-smi`` reports them. Needs a card: the metrics are the
card's.

    python -m mpc_for_av_at_intersection_tpu_torch.bench
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .mpc.controller import CUDA

HORIZON = 20
BATCH = 4096
N_COURSE = 512
STEADY_ITERS = 20
FLEET_SCENARIOS, FLEET_STEPS = 1024, 32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(seed: int, fleet: bool = True, device=CUDA) -> dict:
    """The two measurements at the module's sizes on ``device`` (the card
    unless the caller names the CPU, where the numbers say nothing of a
    card). Returns the JSON line's fields and the times behind them."""
    from .core.angles import smooth_yaw_numpy
    from .models import bicycle_geometry
    from .mpc import MPCConfig, init_controller_state
    from .mpc.batch import mpc_step_batched

    batch, horizon, n_course, steady_iters = BATCH, HORIZON, N_COURSE, STEADY_ITERS
    fleet_scenarios, fleet_steps = FLEET_SCENARIOS, FLEET_STEPS
    device = torch.device(device)
    geom = bicycle_geometry()
    cfg = MPCConfig(T=horizon)
    f32 = torch.float32

    # realistic per-scenario tracking instances: smooth random courses,
    # ego states near the course with varying speed (bench.py:50-75)
    rng = np.random.default_rng(seed)
    dl = 0.083
    turn = rng.normal(0.0, 0.01, size=(batch, n_course)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(batch, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(0, batch, max(batch // 64, 1)):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    i0 = rng.integers(3, 40, size=batch)
    state = np.stack([
        course[np.arange(batch), i0, 0] + rng.normal(0, 0.2, batch),
        course[np.arange(batch), i0, 1] + rng.normal(0, 0.2, batch),
        rng.uniform(0.0, 8.0, batch),
        course[np.arange(batch), i0, 2] + rng.normal(0, 0.1, batch),
    ], axis=1)

    course_t = torch.tensor(course, dtype=f32, device=device)
    state_t = torch.tensor(state, dtype=f32, device=device)
    cv = torch.zeros((batch, n_course), dtype=f32, device=device)
    valid_len = torch.full((batch,), n_course, dtype=torch.int32, device=device)
    dl_t = torch.full((batch,), dl, dtype=f32, device=device)
    cs = init_controller_state(cfg, f32, device=device, batch=batch)

    def solve_batch(cs):
        return mpc_step_batched(state_t, course_t, cv, valid_len, dl_t, cs, cfg,
                                geom.wheelbase).state

    # the first call loads the kernels' library (built once, keyed by the
    # sources) and solves cold
    _sync(device)
    t0 = time.perf_counter()
    cs1 = solve_batch(cs)
    _sync(device)
    first_exec_s = time.perf_counter() - t0

    # steady state: feed the updated controller state back (warm-started
    # solves, like a real receding-horizon fleet)
    t0 = time.perf_counter()
    for _ in range(steady_iters):
        cs1 = solve_batch(cs1)
    _sync(device)
    dt_iter = (time.perf_counter() - t0) / steady_iters
    out = {"metric": f"mpc_solves_per_sec_per_chip_T{horizon}",
           "value": round(batch / dt_iter, 1), "unit": "solves/s/chip"}

    # real-junction fleet metric: scenario ticks/s through the FULL
    # pipeline — localization, prediction, conflict scan, cutoff, QP, plant
    if fleet:
        from . import api
        from .engine import EngineConfig
        from .parallel import run_batch_episodes, stack_states, stack_worlds

        geom_f, worlds, states, _ = api.sample_intersection_fleet(
            fleet_scenarios, np.random.default_rng(seed), n_steps=fleet_steps, device=device)
        wb, sb = stack_worlds(worlds), stack_states(states)
        _, _, summary = run_batch_episodes(wb, sb, EngineConfig(), geom_f, fleet_steps)
        int(summary["n_done"])
        t0 = time.perf_counter()
        _, _, summary = run_batch_episodes(wb, sb, EngineConfig(), geom_f, fleet_steps)
        int(summary["n_done"])   # real value fetch ends the bracket
        out["fleet_scenario_ticks_per_s"] = round(
            fleet_scenarios * fleet_steps / (time.perf_counter() - t0), 1)
    return {"line": out, "iter_s": dt_iter, "first_exec_s": first_exec_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the bench measures the card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    seed = int.from_bytes(os.urandom(4), "little")
    res = run_bench(seed, fleet=os.environ.get("BENCH_FLEET", "1") == "1")
    print(json.dumps(res["line"]))
    print(f"# batch={BATCH} iter_time={res['iter_s'] * 1e3:.3f}ms "
          f"first_exec={res['first_exec_s']:.1f}s seed={seed} "
          f"device={torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi.stdout.strip().splitlines()[0]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
