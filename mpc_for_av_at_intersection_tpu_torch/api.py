"""High-level entry points: course planning, the scenario drivers and the fleet builders.

Port of ``mpc_for_av_at_intersection_tpu/api.py``:
- ``plan_course`` (the host search: the native C++ core, else the Python
  search) and ``plan_courses_batch`` (the device planner, kernel K3 on the
  card, with the native core re-planning its misses);
- the scenario drivers, declarative builders of the reference's per-scenario
  driver scripts, each returning a ``DriverSetup`` ready for
  ``engine.run_episode`` (``build_multi_ego_intersection``: for
  ``engine.run_multi_ego_episode``):

  - mpc_intersection.py            -> build_intersection (flagship)
  - mpc_basic.py (9 canned setups) -> build_t_intersection_basic(scenario_no)
  - mpc_roundabout.py              -> build_roundabout
  - mpc_intersection_multi_lane.py -> build_intersection_multi_lane
  - mpc_intersection_new_ref.py    -> build_intersection_speed_ref
  - overtaking_cyclist_bidirectional_road.py -> build_overtaking_cyclist
  - interactive_mpc.py (broken upstream)     -> build_multi_ego_intersection

- the Monte-Carlo builders: ``sample_intersection_fleet`` (per-scenario
  worlds and states), ``sample_intersection_fleet_batched`` (the same fleet
  stacked) and ``sample_intersection_fleet_geom`` (every scenario on its own
  sampled junction geometry). The stacked builders return ``(geom, world,
  state, meta)`` tensors ready for ``parallel.run_batch_episodes``.

Every builder puts its tensors on ``device`` (the card unless the caller
names another).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .agents import (
    AgentParams,
    AgentStates,
    make_arterial_agent,
    make_roundabout_agent,
    make_t_intersection_agent,
    stack_agents,
)
from .core.angles import smooth_yaw_numpy
from .engine.closed_loop import (
    EngineConfig,
    EngineState,
    WorldArrays,
    init_engine_state,
    make_world,
)
from .engine.multi_ego import init_multi_ego_state, make_multi_ego_world
from .lattice import MotionPrimitiveSearch, NoPathError, SearchWeights, primitive_table
from .models import VehicleGeometry, bicycle_geometry
from .mpc.config import MPCConfig
from .mpc.controller import CUDA, init_controller_state
from .native import NativeMotionPrimitiveSearch, native_available
from .worlds import (
    arterial_multi_lanes,
    intersection,
    intersection_multi_lanes,
    roundabout,
    roundabout_big,
    t_intersection,
)

# the host search's budget where sampled junctions may have no path: a
# plannable junction needs a few hundred expansions, an unplannable one
# spends the whole budget (the JAX package's sampling contexts)
SAMPLING_MAX_EXPANSIONS = 150_000
# the device planner's budget on sampled geometries, and its chunk of
# scenarios per search
GEOM_MAX_EXPANSIONS = 20_000
GEOM_CHUNK = 1024


@dataclasses.dataclass
class DriverSetup:
    geom: VehicleGeometry
    world: object
    state0: object
    cfg: EngineConfig
    trajectory: np.ndarray
    trajectories: Optional[List[np.ndarray]] = None  # multi-ego
    scenario: Optional[object] = None                # world geometry (viz)


def plan_course(scenario, geom: VehicleGeometry,
                weights: SearchWeights = SearchWeights.modified(), use_native: bool = True,
                max_expansions: Optional[int] = None) -> np.ndarray:
    """Global plan of one scenario by the host lattice search: the native
    C++ core when it builds (bit-equal to the Python search), else the
    Python search. ``max_expansions`` caps the native search's budget
    (default 2M); the Python search takes no cap."""
    table = primitive_table(geom)
    if use_native and native_available():
        kw = {"max_expansions": int(max_expansions)} if max_expansions else {}
        search = NativeMotionPrimitiveSearch(scenario, geom, table, margin=geom.radius,
                                             weights=weights, **kw)
    else:
        search = MotionPrimitiveSearch(scenario, geom, table, margin=geom.radius,
                                       weights=weights)
    _, _, trajectory = search.run()
    return trajectory


def _single(scenario, rows, cfg, weights=SearchWeights.modified(), geom=None, n_steps=256,
            device=CUDA) -> DriverSetup:
    geom = geom or bicycle_geometry()
    trajectory = plan_course(scenario, geom, weights)
    params, ag = stack_agents(rows, n_slots=cfg.n_agents)
    world = make_world(trajectory, params, cfg, device=device)
    state0 = init_engine_state(world, ag, cfg, n_steps, device=device)
    return DriverSetup(geom, world, state0, cfg, trajectory, scenario=scenario)


def build_intersection(start_pos: int = 4, turn_indicator: int = 1, other_vehicles: bool = True,
                       cfg: Optional[EngineConfig] = None, n_steps: int = 256,
                       device=CUDA) -> DriverSetup:
    """The flagship driver (reference ``mpc_intersection.py:26-51``)."""
    cfg = cfg or EngineConfig()
    rows = []
    if other_vehicles:
        rows = [
            make_t_intersection_agent(direction=1, turning=False, speed=25 / 3.6, offset=2.0),
            make_t_intersection_agent(direction=-1, turning=True, speed=25 / 3.6, offset=4.0),
        ]
    return _single(intersection(turn_indicator=turn_indicator, start_pos=start_pos), rows, cfg,
                   n_steps=n_steps, device=device)


# the 9 canned T-intersection traffic setups of mpc_basic.py:131-169
# (direction, offset, turning, speed) per vehicle
_BASIC_SCENARIOS: Dict[int, List[Tuple[int, float, bool, float]]] = {
    1: [],
    2: [(1, 1.0, False, 30 / 3.6)],
    3: [(1, 0.0, False, 30 / 3.6), (-1, 1.0, True, 25 / 3.6)],
    4: [(1, 0.0, False, 30 / 3.6), (1, 3.0, False, 30 / 3.6)],
    5: [(-1, 0.0, True, 20 / 3.6), (-1, 3.0, True, 20 / 3.6)],
    6: [(1, 0.0, True, 30 / 3.6), (1, 3.0, True, 30 / 3.6)],
    7: [(-1, 0.0, False, 30 / 3.6), (-1, 5.0, False, 30 / 3.6)],
    8: [(1, 0.0, False, 30 / 3.6), (-1, 0.0, False, 30 / 3.6), (-1, 5.0, False, 30 / 3.6)],
    9: [(1, 2.0, False, 25 / 3.6), (-1, 4.0, True, 25 / 3.6)],
}


def build_t_intersection_basic(scenario_no: int = 9, turn_indicator: int = 1, start_pos: int = 1,
                               cfg: Optional[EngineConfig] = None, n_steps: int = 256,
                               device=CUDA) -> DriverSetup:
    """The basic T-intersection driver (reference ``mpc_basic.py``; its nine
    canned traffic setups map to ``scenario_no`` 1-9)."""
    cfg = cfg or EngineConfig()
    rows = [make_t_intersection_agent(direction=d, turning=t, speed=s, offset=o)
            for (d, o, t, s) in _BASIC_SCENARIOS[scenario_no]]
    return _single(t_intersection(turn_indicator=turn_indicator, start_pos=start_pos), rows, cfg,
                   weights=SearchWeights.base(), n_steps=n_steps, device=device)


def build_roundabout(start_pos: int = 1, turn_indicator: int = 4, other_vehicles: bool = True,
                     big: bool = True, cfg: Optional[EngineConfig] = None, n_steps: int = 320,
                     device=CUDA) -> DriverSetup:
    """Roundabout driver (reference ``mpc_roundabout.py:31-49``).

    The reference driver runs the BIG roundabout geometry
    (``mpc_roundabout.py:11`` imports ``envs.roundabout_big``; road 4.2,
    island 4, center r=4) with start_pos=1, turn_indicator=4 (a U-turn) and
    two scripted roundabout vehicles, the defaults here. The U-turn is
    feasible only on the big geometry (QUIRKS #18). ``big=False`` gives the
    small-geometry variant (``envs/roundabout.py``)."""
    cfg = cfg or EngineConfig()
    rows = []
    if other_vehicles:
        rows = [
            make_roundabout_agent(direction=1, turning=True, speed=25 / 3.6, offset=1.0),
            make_roundabout_agent(direction=-1, turning=True, speed=25 / 3.6, offset=4.0),
        ]
    env = roundabout_big if big else roundabout
    return _single(env(turn_indicator=turn_indicator, start_pos=start_pos), rows, cfg,
                   weights=SearchWeights.roundabout(), n_steps=n_steps, device=device)


def build_intersection_multi_lane(start_pos: int = 1, turn_indicator: int = 1,
                                  start_lane: int = 1, goal_lane: int = 1,
                                  number_of_lanes: int = 2, cfg: Optional[EngineConfig] = None,
                                  n_steps: int = 256, device=CUDA) -> DriverSetup:
    """Multi-lane intersection driver (reference
    ``mpc_intersection_multi_lane.py:34-45``; no moving obstacles)."""
    cfg = cfg or EngineConfig()
    return _single(
        intersection_multi_lanes(turn_indicator=turn_indicator, start_pos=start_pos,
                                 start_lane=start_lane, goal_lane=goal_lane,
                                 number_of_lanes=number_of_lanes),
        [], cfg, n_steps=n_steps, device=device)


def build_intersection_speed_ref(start_pos: int = 1, turn_indicator: int = 1,
                                 cfg: Optional[EngineConfig] = None, n_steps: int = 256,
                                 device=CUDA) -> DriverSetup:
    """Speed-reference yielding driver (reference
    ``mpc_intersection_new_ref.py``): keeps the full path and zeroes the
    reference speed past the conflict instead of truncating."""
    cfg = cfg or EngineConfig(mpc=MPCConfig.with_speed_ref(), yield_by_speed=True)
    rows = [
        make_t_intersection_agent(direction=1, turning=False, speed=25 / 3.6, offset=1.0),
        make_t_intersection_agent(direction=-1, turning=True, speed=25 / 3.6, offset=4.0),
    ]
    return _single(intersection(turn_indicator=turn_indicator, start_pos=start_pos), rows, cfg,
                   n_steps=n_steps, device=device)


def build_overtaking_cyclist(num_lanes: int = 2, goal_lane: int = 1,
                             cfg: Optional[EngineConfig] = None, n_steps: int = 256,
                             device=CUDA) -> DriverSetup:
    """Overtake-a-slow-rider driver (reference
    ``overtaking_cyclist_bidirectional_road.py:76-82``). The 100 m arterial
    course needs the larger trajectory buffer."""
    cfg = cfg or EngineConfig(n_traj=2048)
    scenario = arterial_multi_lanes(num_lanes=num_lanes, goal_lane=goal_lane)
    rows = [make_arterial_agent(x_init=scenario.start[0], y_init=scenario.start[1] + 30.0,
                                speed=25 / 3.6, offset=1.0)]
    return _single(scenario, rows, cfg, n_steps=n_steps, device=device)


def build_multi_ego_intersection(configs: List[Tuple[int, int]] = ((1, 2), (4, 1)),
                                 cfg: Optional[EngineConfig] = None, n_steps: int = 256,
                                 device=CUDA) -> DriverSetup:
    """E egos crossing one intersection (the capability the reference's
    interactive_mpc.py intended). ``configs`` is a list of (start_pos,
    turn_indicator) per ego."""
    cfg = cfg or EngineConfig()
    geom = bicycle_geometry()
    trajs = [plan_course(intersection(turn_indicator=t, start_pos=s), geom) for (s, t) in configs]
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world(trajs, params, cfg, device=device)
    state0 = init_multi_ego_state(world, ag, cfg, n_steps, device=device)
    return DriverSetup(geom, world, state0, cfg, trajs[0], trajectories=trajs,
                       scenario=intersection(turn_indicator=configs[0][1],
                                             start_pos=configs[0][0]))


def plan_courses_batch(scenarios, geom: VehicleGeometry,
                       weights: SearchWeights = SearchWeights.modified(), planner: str = "device",
                       wavefront_cfg=None, max_expansions: int = 8192, engine: str = "auto",
                       device=CUDA):
    """Plan a batch of scenarios' global courses.

    planner="device": one batched search over the whole batch on ``device``
    (``lattice.plan_courses_device`` with ``engine``, grid sized from the
    batch geometry unless ``wavefront_cfg`` is given). Every scenario the
    device search misses is re-planned by the host search (``plan_course``,
    the native core at a 150k budget, in 12 threads: the C++ call releases
    the GIL); a goal it cannot reach either gives None.
    planner="native" / "host": the native core (in up to 12 threads) / the
    Python search per scenario.

    Returns (list of (N_i, 3) float64 trajectories, stats dict).
    """
    if planner in ("native", "host"):
        def plan(sc):
            return plan_course(sc, geom, weights, use_native=(planner == "native"))

        if planner == "native":
            with ThreadPoolExecutor(max_workers=max(1, min(len(scenarios), 12))) as ex:
                courses = list(ex.map(plan, scenarios))
        else:
            courses = [plan(sc) for sc in scenarios]
        return courses, {"planner": planner, "n_device": 0, "n_host_fallback": 0}
    if planner != "device":
        raise ValueError(f"unknown planner {planner!r}")
    from .lattice import plan_courses_device

    res = plan_courses_device(scenarios, geom, weights=weights, cfg=wavefront_cfg, engine=engine,
                              max_expansions=max_expansions, device=device)
    found = res.found.cpu().numpy()
    n_points = res.n_points.cpu().numpy()
    traj_all = res.trajectory.cpu().numpy()
    miss = [i for i in range(len(scenarios)) if not found[i]]

    def host_plan(i):
        try:
            return plan_course(scenarios[i], geom, weights,
                               max_expansions=SAMPLING_MAX_EXPANSIONS)
        except NoPathError:
            return None

    t0 = time.perf_counter()
    fallback = {}
    if miss:
        print(f"plan_courses_batch: {len(miss)}/{len(scenarios)} host fallbacks",
              file=sys.stderr, flush=True)
        with ThreadPoolExecutor(max_workers=12) as ex:
            fallback = dict(zip(miss, ex.map(host_plan, miss)))
    out = [traj_all[i, : int(n_points[i])].astype(np.float64) if found[i] else fallback[i]
           for i in range(len(scenarios))]
    stats = {
        "n_unplannable": sum(fallback[i] is None for i in miss),
        "planner": "device",
        "n_device": len(scenarios) - len(miss),
        "n_host_fallback": len(miss),
        "host_fallback_seconds": time.perf_counter() - t0,
        "device_costs": res.cost.cpu().numpy(),
        "oob": res.oob.cpu().numpy(),
    }
    return out, stats


def _plan_keys(keys, geom, planner, device):
    """Courses of the unique (start, turn) junctions, planned by
    ``plan_courses_batch``."""
    return plan_courses_batch([intersection(turn_indicator=t, start_pos=s) for (s, t) in keys],
                              geom, planner=planner, device=device)


def sample_intersection_fleet(
    n_scenarios: int,
    rng: np.random.Generator,
    cfg: Optional[EngineConfig] = None,
    n_steps: int = 256,
    starts=(1, 2, 3, 4),
    turns=(1, 2, 3),
    planner: str = "native",
    device=CUDA,
):
    """Monte-Carlo fleet over (start, turn, arrival schedule), one world and
    state per scenario on ``device`` (stack them with
    ``parallel.stack_worlds`` / ``stack_states``). The courses are planned
    once per unique (start, turn): on the device in one search
    (``planner="device"``, host re-plans per miss), on the native core or
    on the Python search. Returns (geom, worlds, states, meta list)."""
    cfg = cfg or EngineConfig()
    geom = bicycle_geometry()
    draws = [(int(rng.choice(starts)), int(rng.choice(turns))) for _ in range(n_scenarios)]
    keys = sorted(set(draws))
    courses, _ = _plan_keys(keys, geom, planner, device)
    course_cache = dict(zip(keys, courses))
    worlds, states, meta = [], [], []
    for (s, t) in draws:
        rows = []
        for direction in (1, -1):
            if rng.random() < 0.8:
                rows.append(make_t_intersection_agent(
                    direction=direction, turning=bool(rng.random() < 0.5),
                    speed=float(rng.uniform(15, 32)) / 3.6, offset=float(rng.uniform(0.0, 6.0))))
        params, ag = stack_agents(rows, n_slots=cfg.n_agents)
        world = make_world(course_cache[(s, t)], params, cfg, device=device)
        worlds.append(world)
        states.append(init_engine_state(world, ag, cfg, n_steps, device=device))
        meta.append({"start_pos": s, "turn_indicator": t, "n_agents": len(rows)})
    return geom, worlds, states, meta


def sample_intersection_fleet_batched(
    n_scenarios: int,
    rng: np.random.Generator,
    cfg: Optional[EngineConfig] = None,
    n_steps: int = 256,
    starts=(1, 2, 3, 4),
    turns=(1, 2, 3),
    planner: str = "native",
    dtype=torch.float32,
    device=CUDA,
):
    """Monte-Carlo fleet over (start, turn, arrival schedule) as stacked
    ``(geom, world_batch, state_batch, meta)`` on ``device``: the fleet of
    ``sample_intersection_fleet`` for the same rng, built as the unique
    padded course rows and one gather. The unique (start, turn) courses are
    planned once each (``planner`` as there); ``meta["planner_stats"]``
    holds the planner's counts and its seconds."""
    cfg = cfg or EngineConfig()
    geom = bicycle_geometry()
    S = n_scenarios
    draws = [(int(rng.choice(starts)), int(rng.choice(turns))) for _ in range(S)]
    keys = sorted(set(draws))
    t0 = time.perf_counter()
    courses, stats = _plan_keys(keys, geom, planner, device)
    stats = dict(stats, seconds=time.perf_counter() - t0)
    if any(c is None for c in courses):
        raise RuntimeError("a standard junction has no path")
    key_pos = {k: i for i, k in enumerate(keys)}
    kidx = np.asarray([key_pos[d] for d in draws], np.int64)
    world, state, present = _assemble_fleet_arrays(
        *_pad_courses(courses, cfg.n_traj), kidx, rng, cfg, n_steps, dtype, device)
    meta = {
        "start_pos": np.asarray([d[0] for d in draws], np.int32),
        "turn_indicator": np.asarray([d[1] for d in draws], np.int32),
        "n_agents": present.sum(axis=1).astype(np.int32),
        "planner_stats": stats,
    }
    return geom, world, state, meta


def sample_intersection_fleet_geom(
    n_scenarios: int,
    rng: np.random.Generator,
    cfg: Optional[EngineConfig] = None,
    n_steps: int = 256,
    starts=(1, 2, 3, 4),
    turns=(1, 2, 3),
    road_range=(3.4, 5.2),
    island_range=(1.4, 3.0),
    corner_radius_range=(5.0, 7.5),
    planner: str = "device",
    dtype=torch.float32,
    device=CUDA,
):
    """Monte-Carlo fleet over sampled junction GEOMETRY: every scenario gets
    its own road width, median width and corner radius from the given
    ranges (the reference hard-codes 4.0 / 2.0 / 6.0), plus the usual
    start/turn and arrival schedule, drawn from ``rng`` in the JAX
    package's order.

    planner="device": the batch is planned on ``device`` in chunks of
    ``GEOM_CHUNK`` scenarios on one grid sized over the whole batch, at
    ``GEOM_MAX_EXPANSIONS``; the native core re-plans the misses. Unlike the
    JAX package, which plans a batch of at most 1024 on its Python search,
    every batch size takes the device, and the stats count real rows only
    (the last chunk is not padded). planner="native" / "host": the native
    core (150k budget) / the Python search per scenario. A junction with
    no path, or a course longer than the buffer, gets a fresh geometry
    draw (up to 8), planned by the native core at a 150k budget.

    Returns stacked ``(geom, world_batch, state_batch, meta)``; ``meta``
    also holds the geometry draws and the planner stats, with
    ``n_resampled_geometry``. The course buffer defaults to
    ``EngineConfig(n_traj=1536)``: sampled junctions give longer courses.
    """
    from .lattice.wavefront import grid_for

    cfg = cfg or EngineConfig(n_traj=1536)
    geom = bicycle_geometry()
    S = n_scenarios
    start_d = np.asarray([int(rng.choice(starts)) for _ in range(S)])
    turn_d = np.asarray([int(rng.choice(turns)) for _ in range(S)])
    road_d = rng.uniform(*road_range, size=S)
    island_d = rng.uniform(*island_range, size=S)
    corner_d = rng.uniform(*corner_radius_range, size=S)

    def junction(i):
        return intersection(turn_indicator=int(turn_d[i]), start_pos=int(start_d[i]),
                            road=float(road_d[i]), island=float(island_d[i]),
                            corner_radius=float(corner_d[i]))

    scenarios = [junction(i) for i in range(S)]
    t0 = time.perf_counter()
    if planner == "device":
        engine, wf_cfg = grid_for(scenarios)
        courses = []
        stats = {"planner": "device", "n_device": 0, "n_host_fallback": 0,
                 "n_unplannable": 0, "host_fallback_seconds": 0.0}
        for lo in range(0, S, GEOM_CHUNK):
            out, st = plan_courses_batch(
                scenarios[lo:lo + GEOM_CHUNK], geom, planner="device", wavefront_cfg=wf_cfg,
                max_expansions=GEOM_MAX_EXPANSIONS, engine=engine, device=device)
            courses.extend(out)
            for k in ("n_device", "n_host_fallback", "n_unplannable", "host_fallback_seconds"):
                stats[k] += st[k]
    elif planner in ("native", "host"):
        courses = []
        for sc in scenarios:
            try:
                courses.append(plan_course(sc, geom, use_native=(planner == "native"),
                                           max_expansions=SAMPLING_MAX_EXPANSIONS))
            except NoPathError:
                courses.append(None)
        stats = {"planner": planner, "n_device": 0, "n_host_fallback": 0}
    else:
        raise ValueError(f"unknown planner {planner!r}")

    n_traj = cfg.n_traj
    n_resampled = 0
    for i in range(S):
        tries = 0
        # None = unplannable; over-length = junction too large for the
        # course buffer; both get a fresh geometry draw
        while (courses[i] is None or len(courses[i]) > n_traj) and tries < 8:
            tries += 1
            road_d[i] = rng.uniform(*road_range)
            island_d[i] = rng.uniform(*island_range)
            corner_d[i] = rng.uniform(*corner_radius_range)
            try:
                traj = plan_course(junction(i), geom, use_native=True,
                                   max_expansions=SAMPLING_MAX_EXPANSIONS)
            except NoPathError:
                continue
            if len(traj) <= n_traj:
                courses[i] = traj
                n_resampled += 1
        if courses[i] is None or len(courses[i]) > n_traj:
            raise RuntimeError(f"scenario {i} unplannable after {tries} geometry redraws")
    stats = dict(stats, n_resampled_geometry=n_resampled, seconds=time.perf_counter() - t0)

    world, state, present = _assemble_fleet_arrays(
        *_pad_courses(courses, n_traj), np.arange(S, dtype=np.int64), rng, cfg, n_steps, dtype,
        device)
    meta = {
        "start_pos": start_d.astype(np.int32),
        "turn_indicator": turn_d.astype(np.int32),
        "road": road_d,
        "island": island_d,
        "corner_radius": corner_d,
        "n_agents": present.sum(axis=1).astype(np.int32),
        "planner_stats": stats,
    }
    return geom, world, state, meta


def _pad_courses(courses, n_traj):
    """Course rows padded to ``n_traj`` with their last point (make_world
    semantics, yaw unwrapped): (courses (K, n_traj, 3), lengths, dl, goal)."""
    K = len(courses)
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
    return courses_u, n_u, dl_u, goal_u


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
