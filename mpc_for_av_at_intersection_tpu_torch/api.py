"""Driver API of the fleet path: course planning and the fleet builder.

Port of the part of ``mpc_for_av_at_intersection_tpu/api.py`` that the
fleet path runs: ``plan_course`` (the host search), ``plan_courses_batch``
(kernel K3 on the card, host search for its misses) and
``sample_intersection_fleet_batched``, which returns stacked
``(geom, world, state, meta)`` tensors ready for
``parallel.run_batch_episodes``.

The port's planner default is ``"device"``: the JAX package's default,
``"native"``, runs its C++ host search, which is not ported yet
(``planner="native"`` raises).
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import torch

from .agents import AgentParams, AgentStates
from .core.angles import smooth_yaw_numpy
from .engine.closed_loop import EngineConfig, EngineState, WorldArrays
from .lattice import MotionPrimitiveSearch, NoPathError, SearchWeights, primitive_table
from .models import VehicleGeometry, bicycle_geometry
from .mpc.controller import CUDA, init_controller_state
from .worlds import intersection


def plan_course(scenario, geom: VehicleGeometry,
                weights: SearchWeights = SearchWeights.modified()) -> np.ndarray:
    """Global plan of one scenario by the host lattice search (Python; the
    JAX package's C++ search is not ported yet)."""
    search = MotionPrimitiveSearch(scenario, geom, primitive_table(geom), margin=geom.radius,
                                   weights=weights)
    _, _, trajectory = search.run()
    return trajectory


def plan_courses_batch(scenarios, geom: VehicleGeometry,
                       weights: SearchWeights = SearchWeights.modified(), planner: str = "device",
                       wavefront_cfg=None, max_expansions: int = 8192, device=CUDA):
    """Plan a batch of scenarios' global courses.

    planner="device": one batched search over the whole batch on ``device``
    (``lattice.plan_courses_device``, grid sized from the batch geometry).
    Any scenario the device search misses falls back to the host search, so
    the result is complete; a genuinely unreachable goal gives None.
    planner="host": the host search per scenario.

    Returns (list of (N_i, 3) float64 trajectories, stats dict).
    """
    if planner == "native":
        raise NotImplementedError(
            "planner='native' needs the C++ host search, which is not ported yet "
            "(ROADMAP queue 1, item 8); use planner='device' or 'host'")
    if planner == "host":
        return ([plan_course(sc, geom, weights) for sc in scenarios],
                {"planner": planner, "n_device": 0, "n_host_fallback": 0})
    if planner != "device":
        raise ValueError(f"unknown planner {planner!r}")
    from .lattice import plan_courses_device

    res = plan_courses_device(scenarios, geom, weights=weights, cfg=wavefront_cfg,
                              max_expansions=max_expansions, device=device)
    found = res.found.cpu().numpy()
    n_points = res.n_points.cpu().numpy()
    traj_all = res.trajectory.cpu().numpy()
    miss = [i for i in range(len(scenarios)) if not found[i]]
    if miss:
        print(f"plan_courses_batch: {len(miss)}/{len(scenarios)} host fallbacks",
              file=sys.stderr, flush=True)
    out, n_unplannable = [], 0
    for i, sc in enumerate(scenarios):
        if found[i]:
            out.append(traj_all[i, : int(n_points[i])].astype(np.float64))
            continue
        try:
            out.append(plan_course(sc, geom, weights))
        except NoPathError:
            n_unplannable += 1
            out.append(None)
    stats = {
        "n_unplannable": n_unplannable,
        "planner": "device",
        "n_device": len(scenarios) - len(miss),
        "n_host_fallback": len(miss),
        "device_costs": res.cost.cpu().numpy(),
        "oob": res.oob.cpu().numpy(),
    }
    return out, stats


def sample_intersection_fleet_batched(
    n_scenarios: int,
    rng: np.random.Generator,
    cfg: Optional[EngineConfig] = None,
    n_steps: int = 256,
    starts=(1, 2, 3, 4),
    turns=(1, 2, 3),
    planner: str = "device",
    dtype=torch.float32,
    device=CUDA,
):
    """Monte-Carlo fleet over (start, turn, arrival schedule) as stacked
    ``(geom, world_batch, state_batch, meta)`` on ``device``. The draws
    take the rng in the JAX package's order, so the same seed gives the
    same fleet. The unique (start, turn) courses are planned once each;
    ``meta["planner_stats"]`` holds the planner's counts and its seconds."""
    cfg = cfg or EngineConfig()
    geom = bicycle_geometry()
    S = n_scenarios
    draws = [(int(rng.choice(starts)), int(rng.choice(turns))) for _ in range(S)]
    keys = sorted(set(draws))
    t0 = time.perf_counter()
    courses, stats = plan_courses_batch(
        [intersection(turn_indicator=t, start_pos=s) for (s, t) in keys], geom,
        planner=planner, device=device)
    stats = dict(stats, seconds=time.perf_counter() - t0)
    if any(c is None for c in courses):
        raise RuntimeError("a standard junction has no path")

    # unique padded world rows (make_world semantics, once per key)
    K = len(keys)
    n_traj = cfg.n_traj
    courses_u = np.zeros((K, n_traj, 3), np.float64)
    n_u = np.zeros((K,), np.int32)
    dl_u = np.zeros((K,), np.float64)
    goal_u = np.zeros((K, 2), np.float64)
    for ki, traj in enumerate(courses):
        traj = np.asarray(traj, np.float64).copy()
        traj[:, 2] = smooth_yaw_numpy(traj[:, 2])
        n = len(traj)
        if n > n_traj:
            raise ValueError(f"trajectory length {n} > n_traj={n_traj}")
        courses_u[ki, :n] = traj
        courses_u[ki, n:] = traj[-1]
        n_u[ki] = n
        dl_u[ki] = np.linalg.norm(traj[1, :2] - traj[0, :2])
        goal_u[ki] = traj[-1, :2]
    key_pos = {k: i for i, k in enumerate(keys)}
    kidx = np.asarray([key_pos[d] for d in draws], np.int64)

    world, state, present = _assemble_fleet_arrays(
        courses_u, n_u, dl_u, goal_u, kidx, rng, cfg, n_steps, dtype, device)
    meta = {
        "start_pos": np.asarray([d[0] for d in draws], np.int32),
        "turn_indicator": np.asarray([d[1] for d in draws], np.int32),
        "n_agents": present.sum(axis=1).astype(np.int32),
        "planner_stats": stats,
    }
    return geom, world, state, meta


def _assemble_fleet_arrays(courses_u, n_u, dl_u, goal_u, kidx, rng, cfg: EngineConfig,
                           n_steps, dtype, device):
    """Sample the arrival schedules (the JAX package's rng sequence), pack
    the agents, gather the per-scenario course rows and build the stacked
    (WorldArrays, EngineState). ``courses_u`` holds the unique padded course
    rows and ``kidx`` maps scenarios to them. Float fields take ``dtype``."""
    S = kidx.shape[0]
    present = np.zeros((S, 2), bool)
    turning = np.zeros((S, 2), bool)
    speed = np.zeros((S, 2), np.float64)
    offset = np.zeros((S, 2), np.float64)
    for i in range(S):
        for j in range(2):
            if rng.random() < 0.8:
                present[i, j] = True
                turning[i, j] = rng.random() < 0.5
                speed[i, j] = rng.uniform(15, 32) / 3.6
                offset[i, j] = rng.uniform(0.0, 6.0)

    # pack present agents first (stack_agents slot order), pad to n_agents
    n_slots = cfg.n_agents
    order = np.argsort(~present, axis=1, kind="stable")
    rowsel = np.arange(S)[:, None]
    p_pk = present[rowsel, order]
    t_pk = turning[rowsel, order]
    s_pk = speed[rowsel, order]
    o_pk = offset[rowsel, order]
    # dir index 0 -> direction +1, pose (-30, -3, 0), x_turn -10;
    # dir index 1 -> direction -1, pose (30, 3, pi), x_turn 12
    d_pk = np.where(order == 0, 1.0, -1.0)
    xt_pk = np.where(order == 0, -10.0, 12.0)
    pose_pk = np.where((order == 0)[..., None], np.asarray([-30.0, -3.0, 0.0]),
                       np.asarray([30.0, 3.0, np.pi]))

    def slotpad(a, default, dt_):
        out = np.full((S, n_slots) + a.shape[2:], default, dt_)
        out[:, :2] = np.where(p_pk.reshape(p_pk.shape + (1,) * (a.ndim - 2)), a,
                              np.asarray(default, dt_))
        return out

    def t(a, dt_):
        return torch.as_tensor(a, device=device).to(dt_)

    params = AgentParams(
        policy=t(slotpad(np.zeros((S, 2)), 0, np.int32), torch.int32),
        direction=t(slotpad(d_pk, 1.0, np.float64), dtype),
        turning=t(slotpad(t_pk, False, bool), torch.bool),
        speed=t(slotpad(s_pk, 0.0, np.float64), dtype),
        offset=t(slotpad(o_pk, 0.0, np.float64), dtype),
        x_turn=t(slotpad(xt_pk, 0.0, np.float64), dtype),
        active=t(slotpad(p_pk, False, bool), torch.bool),
    )
    agents = AgentStates(pose=t(slotpad(pose_pk, 0.0, np.float64), dtype),
                         counter=torch.zeros((S, n_slots), dtype=torch.int32, device=device))

    kidx_t = torch.as_tensor(kidx, device=device)
    course_b = t(courses_u, dtype)[kidx_t]
    world = WorldArrays(
        course=course_b,
        n_course=t(n_u, torch.int32)[kidx_t],
        dl=t(dl_u, dtype)[kidx_t],
        goal_xy=t(goal_u, dtype)[kidx_t],
        agent_params=params,
    )
    ego = torch.cat([course_b[:, 0, :2], torch.zeros((S, 1), dtype=dtype, device=device),
                     course_b[:, 0, 2:3]], dim=1)
    state = EngineState(
        ego=ego,
        ctrl=init_controller_state(cfg.mpc, dtype, device=device, batch=S),
        agents=agents,
        cutoff_len=world.n_course.clone(),
        agent_idx=torch.zeros((S,), dtype=torch.int32, device=device),
        first_tick=torch.ones((S,), dtype=torch.bool, device=device),
        done=torch.zeros((S,), dtype=torch.bool, device=device),
        ticks_to_goal=torch.full((S,), n_steps, dtype=torch.int32, device=device),
        tick=torch.zeros((S,), dtype=torch.int32, device=device),
    )
    return world, state, present
