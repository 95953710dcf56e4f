"""Per-stage profile of the fleet engine tick.

Port of the repository root's ``bench_profile_engine.py``. The fleet is
the flagship sampled-intersection batch (``api.sample_intersection_fleet``,
seed 7, 64-tick state buffers) advanced ``warm_ticks`` ticks, so the stages
see real cutoffs, live conflicts and warm-started controllers. Each stage of
``engine/fleet.py::engine_tick_fleet`` is then timed alone on that state, as
``bench_profile.py`` times the controller's (``StageTimer``).

Stages:
  full_tick               ``engine_tick_fleet``, the cross-check
  predict                 ``agents_get`` + constant-control prediction
  pre                     ``ego_subtick_pre``: the stages below together
  loc                     ... the localization advance alone
  resample                ... the reachability resample + compaction alone
  resample_plus_conflict  ... the resample and the conflict scan
                          (``conflict_ms`` is the difference)
  mpc                     ``mpc_step_batched`` (K1 + K2) on the fleet's inputs
  post                    ``ego_subtick_post`` + ``agents_step``

    python -m mpc_for_av_at_intersection_tpu_torch.bench_profile_engine [out.json]

prints the report as one JSON object (and writes it to ``out.json``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import api
from .agents import agents_get, agents_step, check_collision_moving_cars, predict_constant_control
from .bench_profile import StageTimer, device_name, emit
from .core import nearest_index_in_direction
from .engine import EngineConfig, ego_subtick_post, ego_subtick_pre, engine_tick_fleet
from .engine.closed_loop import resample_suffix
from .mpc.batch import mpc_step_batched
from .parallel import stack_states, stack_worlds


def profile_engine(batch: int = 1024, warm_ticks: int = 12, k_steps: int = 8, reps: int = 5,
                   device=torch.device("cuda")) -> dict:
    """The per-stage report of the fleet tick at ``batch`` scenarios (stage
    times in ms; see the module docstring)."""
    device = torch.device(device)
    cfg = EngineConfig()
    geom, worlds, states, _ = api.sample_intersection_fleet(
        batch, np.random.default_rng(7), cfg, n_steps=64, device=device)
    world = stack_worlds(worlds)
    st = stack_states(states)
    for _ in range(warm_ticks):
        st = engine_tick_fleet(world, st, cfg, geom)[0]

    K = k_steps
    report = {"device": device_name(device), "batch": batch, "warm_ticks": warm_ticks,
              "k_steps": K, "reps": reps, "n_pred": cfg.n_pred, "n_frames": cfg.n_frames,
              "frame_window": cfg.frame_window}
    timed = StageTimer(report, K, reps)
    eps = 1e-30
    dt = cfg.mpc.dt
    circle_centers = torch.as_tensor(geom.circle_centers, dtype=world.course.dtype,
                                     device=device)

    # ---- full engine tick (cross-check) ----
    t_full = timed("full_tick", lambda s: engine_tick_fleet(world, s, cfg, geom)[0], st)

    # ---- prediction ----
    def predict(e):
        obs6 = agents_get(world.agent_params, st.agents, dt)
        preds = predict_constant_control(obs6, dt, geom.wheelbase, cfg.n_pred)
        return e + eps * preds[:, 0, 0, 0]

    t_pred = timed("predict", predict, st.ego[:, 0])
    preds = predict_constant_control(agents_get(world.agent_params, st.agents, dt), dt,
                                     geom.wheelbase, cfg.n_pred)
    active = world.agent_params.active

    def pre_call(ego):
        return ego_subtick_pre(world.course, world.n_course, world.dl, world.goal_xy, ego,
                               st.ctrl, st.cutoff_len, st.agent_idx, st.first_tick, st.done,
                               preds, active, cfg, geom)

    # ---- pre: all of ego_subtick_pre ----
    t_pre = timed("pre", lambda e: e + eps * pre_call(st.ego + (eps * e)[:, None])[3].to(e.dtype),
                  st.cutoff_len.to(world.course.dtype))

    # ---- pre's parts: localization, resample, resample + conflict scan ----
    timed("loc", lambda ai: nearest_index_in_direction(st.ego[:, :2], world.course[:, :, :2], ai,
                                                       world.n_course, forward=True),
          st.agent_idx)

    def resample(e):
        _, _, ego_traj, n_ego = resample_suffix(world.course, world.n_course,
                                                st.ego + (eps * e)[:, None], st.agent_idx, cfg)
        return e + eps * (ego_traj[:, 0, 0] + eps * n_ego)

    t_res = timed("resample", resample, st.ego[:, 0])

    def resample_conflict(e):
        detail, n_detail, ego_traj, n_ego = resample_suffix(
            world.course, world.n_course, st.ego + (eps * e)[:, None], st.agent_idx, cfg)
        scan = check_collision_moving_cars(ego_traj, n_ego, detail, n_detail, preds, active,
                                           circle_centers, geom.radius, cfg.frame_window,
                                           cfg.n_frames)
        return e + eps * (scan.xy[:, 0] + eps * scan.frame_idx)

    t_scan = timed("resample_plus_conflict", resample_conflict, st.ego[:, 0])
    report["conflict_ms"] = t_scan - t_res

    # ---- the controller tick on this fleet's inputs ----
    cv = torch.zeros_like(world.course[:, :, 0])
    t_mpc = timed("mpc", lambda cs: mpc_step_batched(st.ego, world.course, cv, st.cutoff_len,
                                                     world.dl, cs, cfg.mpc,
                                                     geom.wheelbase).state, st.ctrl)

    # ---- post: plant step, freeze, telemetry, agents step ----
    done_now, agent_idx, scan, cutoff_len, course_len, cv_pre = pre_call(st.ego)
    out = mpc_step_batched(st.ego, world.course, cv_pre, course_len, world.dl, st.ctrl, cfg.mpc,
                           geom.wheelbase)

    def post(e):
        (ego, *_), _ = ego_subtick_post(world.course, st.ego + (eps * e)[:, None], st.ctrl,
                                        done_now, agent_idx, scan, cutoff_len, out, cfg, geom)
        agents = agents_step(world.agent_params, st.agents, dt, geom.wheelbase)
        return e + eps * ego[:, 0] + eps * agents.pose[:, 0, 0].to(e.dtype)

    t_post = timed("post", post, st.ego[:, 0])

    accounted = t_pred + t_pre + t_mpc + t_post
    report["accounted_ms"] = accounted
    report["unaccounted_ms"] = t_full - accounted
    report["note"] = (
        "each stage timed alone: k_steps dependent calls ended by a value fetch "
        "(its own cost subtracted), wall / k_steps, median of reps; plain PyTorch stages "
        "include their kernel launches, and loc/resample/conflict also lie "
        "inside pre_ms, so stage sums need not equal full_tick_ms")
    report["ticks_per_s_implied"] = batch / (t_full / 1e3)
    return report


def main(argv=None) -> int:
    return emit(profile_engine(), sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
