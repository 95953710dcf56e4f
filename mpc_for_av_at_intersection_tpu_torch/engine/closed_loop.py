"""The closed-loop receding-horizon engine: world, state and the ego tick.

Port of ``mpc_for_av_at_intersection_tpu/engine/closed_loop.py`` (reference
``main/scenarios/mpc_intersection.py:95-159``) for the fleet path. Per tick:

1. goal test (on the previous tick's controller state),
2. advance the driver's own course-localization index (frozen once the
   cut course has collapsed to the agent's position, :100-105),
3. ego reachability resampling of the remaining course (:110-116),
4. constant-control prediction of every moving agent (:119-122),
5. frame-windowed conflict scan (:125-126),
6. course cutoff before the conflict minus a car-length margin (:129-136)
   — or, in speed-reference mode, zeroing of the reference speed past the
   conflict (``mpc_intersection_new_ref.py:122-139``),
7. MPC solve, 8. agents step, 9. plant step.

``ego_subtick_pre`` and ``ego_subtick_post`` take a batch of scenarios
along the leading axis; ``engine/fleet.py`` runs the MPC solve between
them. ``ego_subtick``, ``engine_tick`` and ``run_episode`` run one
scenario (the JAX package's single-scenario engine): the same stages at
B=1, so on the card each tick launches K1 and K2 once. ``make_world`` and
``init_engine_state`` build one scenario, as in the JAX package (stack them
with ``parallel.stack_worlds``/``stack_states``);
``world_from_numpy``/``engine_state_from_numpy`` carry arrays of the JAX
package over. Finished scenarios freeze in place (QUIRKS #21: all their
state, the scripted agents too).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..agents import AgentParams, AgentStates, check_collision_moving_cars, cutoff_index_by_position
from ..agents.collision import CollisionScan
from ..core.angles import smooth_yaw_numpy
from ..core.curves import compact_by_mask, nearest_index_in_direction, resample_mask, take_rows
from ..core.dynamics import SimLimits, plant_step
from ..models import VehicleGeometry
from ..mpc.config import MPCConfig
from ..mpc.controller import (
    CUDA,
    ControllerState,
    controller_state_from_numpy,
    controller_state_to_numpy,
    init_controller_state,
    is_goal,
    xref_deviation,
)
from ..mpc.batch import mpc_step_batched


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mpc: MPCConfig = MPCConfig.canonical()
    n_traj: int = 1024          # padded course buffer
    n_frames: int = 128         # frame buffer for the conflict scan
    n_agents: int = 4           # padded moving-agent slots
    time_horizon: float = 7.0   # prediction horizon [s]
    frame_window: int = 20
    yield_by_speed: bool = False  # True: speed-ref variant (keep full path)

    @property
    def n_pred(self) -> int:
        return int(np.ceil(self.time_horizon / self.mpc.dt))


class WorldArrays(NamedTuple):
    """Per-scenario constants (batched along a leading axis)."""

    course: torch.Tensor        # (n_traj, 3) padded full reference trajectory
    n_course: torch.Tensor      # () int32
    dl: torch.Tensor            # () course tick
    goal_xy: torch.Tensor       # (2,) original course end
    agent_params: AgentParams   # padded (n_agents,) rows


class EngineState(NamedTuple):
    ego: torch.Tensor           # (4,) x, y, v, yaw
    ctrl: ControllerState
    agents: AgentStates
    cutoff_len: torch.Tensor    # () int32 current course valid length
    agent_idx: torch.Tensor     # () int32 driver-side localization index
    first_tick: torch.Tensor    # () bool
    done: torch.Tensor          # () bool
    ticks_to_goal: torch.Tensor  # () int32 (n_steps if never finished)
    tick: torch.Tensor          # () int32


class Telemetry(NamedTuple):
    """Per-tick telemetry (replaces the reference ``History``)."""

    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor
    v: torch.Tensor
    accel: torch.Tensor
    steer: torch.Tensor
    xref_dev: torch.Tensor
    solved: torch.Tensor
    collision_found: torch.Tensor
    collision_xy: torch.Tensor
    cutoff_len: torch.Tensor
    done: torch.Tensor


_AGENT_INT = ("policy", "counter")
_AGENT_BOOL = ("turning", "active")
_STATE_INT = ("cutoff_len", "agent_idx", "ticks_to_goal", "tick")
_STATE_BOOL = ("first_tick", "done")


def _tensor(a, device):
    """A tensor holding a copy of ``a`` (arrays handed over by other
    frameworks may be read-only)."""
    return torch.tensor(np.array(a), device=device)


def _agents_to_torch(cls, rows, dtype, device):
    """AgentParams/AgentStates of numpy arrays -> tensors; masks bool,
    ids and counters int32, float fields ``dtype`` (None keeps theirs)."""
    rows = rows if isinstance(rows, dict) else rows._asdict()
    out = {}
    for k in cls._fields:
        t = _tensor(rows[k], device)
        if k in _AGENT_BOOL:
            t = t.to(torch.bool)
        elif k in _AGENT_INT:
            t = t.to(torch.int32)
        elif dtype is not None:
            t = t.to(dtype)
        out[k] = t
    return cls(**out)


def make_world(trajectory: np.ndarray, agent_params: AgentParams, cfg: EngineConfig,
               dtype=torch.float32, device=CUDA) -> WorldArrays:
    """Pad a host-side reference trajectory into one scenario's world.

    The course yaw is sequentially unwrapped here, once — replicating the
    reference's in-place ``smooth_yaw`` (see ``core.angles.smooth_yaw_numpy``).
    Float agent fields take ``dtype``, as on the TPU.
    """
    n = len(trajectory)
    if n > cfg.n_traj:
        raise ValueError(f"trajectory length {n} > n_traj={cfg.n_traj}")
    trajectory = np.asarray(trajectory, dtype=np.float64).copy()
    trajectory[:, 2] = smooth_yaw_numpy(trajectory[:, 2])
    course = np.zeros((cfg.n_traj, 3), dtype=np.float64)
    course[:n] = trajectory
    course[n:] = trajectory[-1]
    dl = float(np.linalg.norm(trajectory[1, :2] - trajectory[0, :2]))
    return WorldArrays(
        course=torch.as_tensor(course, dtype=dtype, device=device),
        n_course=torch.tensor(n, dtype=torch.int32, device=device),
        dl=torch.tensor(dl, dtype=dtype, device=device),
        goal_xy=torch.as_tensor(trajectory[-1, :2], dtype=dtype, device=device),
        agent_params=_agents_to_torch(AgentParams, agent_params, dtype, device),
    )


def init_engine_state(world: WorldArrays, agent_states: AgentStates, cfg: EngineConfig,
                      n_steps: int, dtype=torch.float32, device=CUDA) -> EngineState:
    """Cold state of one scenario: the ego at rest on the course start."""
    course = world.course.to(device)
    ego = torch.cat([course[0, :2], torch.zeros((1,), dtype=course.dtype, device=device),
                     course[0, 2:3]]).to(dtype)

    def scalar(v, dt):
        return torch.tensor(v, dtype=dt, device=device)

    return EngineState(
        ego=ego,
        ctrl=init_controller_state(cfg.mpc, dtype, device=device),
        agents=_agents_to_torch(AgentStates, agent_states, dtype, device),
        cutoff_len=world.n_course.to(device),
        agent_idx=scalar(0, torch.int32),
        first_tick=scalar(True, torch.bool),
        done=scalar(False, torch.bool),
        ticks_to_goal=scalar(n_steps, torch.int32),
        tick=scalar(0, torch.int32),
    )


def world_from_numpy(d, device=CUDA) -> WorldArrays:
    """A ``WorldArrays`` from nested dicts of numpy arrays (a JAX world as
    ``{k: np.asarray(v)}``, ``agent_params`` a dict of its own). Float
    fields keep their dtype."""
    return WorldArrays(
        course=_tensor(d["course"], device),
        n_course=_tensor(d["n_course"], device).to(torch.int32),
        dl=_tensor(d["dl"], device),
        goal_xy=_tensor(d["goal_xy"], device),
        agent_params=_agents_to_torch(AgentParams, d["agent_params"], None, device),
    )


def engine_state_from_numpy(d, device=CUDA) -> EngineState:
    """An ``EngineState`` from nested dicts of numpy arrays (``ctrl`` and
    ``agents`` dicts of their own). Masks become bool, indices int32,
    float fields keep their dtype."""
    fields = {}
    for k in EngineState._fields:
        if k == "ctrl":
            fields[k] = controller_state_from_numpy(d[k], device=device)
        elif k == "agents":
            fields[k] = _agents_to_torch(AgentStates, d[k], None, device)
        else:
            t = _tensor(d[k], device)
            if k in _STATE_BOOL:
                t = t.to(torch.bool)
            elif k in _STATE_INT:
                t = t.to(torch.int32)
            fields[k] = t
    return EngineState(**fields)


def world_to_numpy(world: WorldArrays) -> dict:
    """The reverse of ``world_from_numpy``."""
    d = {k: v.detach().cpu().numpy() for k, v in world._asdict().items() if k != "agent_params"}
    d["agent_params"] = {k: v.detach().cpu().numpy() for k, v in world.agent_params._asdict().items()}
    return d


def engine_state_to_numpy(st: EngineState) -> dict:
    """The reverse of ``engine_state_from_numpy``."""
    d = {k: v.detach().cpu().numpy() for k, v in st._asdict().items()
         if k not in ("ctrl", "agents")}
    d["ctrl"] = controller_state_to_numpy(st.ctrl)
    d["agents"] = {k: v.detach().cpu().numpy() for k, v in st.agents._asdict().items()}
    return d


def resample_suffix(course, n_course, ego, agent_idx, cfg: EngineConfig):
    """The course from ``agent_idx`` on (the detailed path, its final row
    repeated past the end) and its ego reachability resample. Returns
    (detail (B, N, 3), n_detail, ego_traj (B, n_frames, 3), n_ego)."""
    mpc_cfg = cfg.mpc
    dt = mpc_cfg.dt
    B, N = course.shape[:2]
    dtype, dev = course.dtype, course.device
    steps = torch.arange(N, device=dev)
    rows = torch.clamp(agent_idx.to(torch.int64)[:, None] + steps[None, :], max=N - 1)
    detail = torch.gather(course, 1, rows[..., None].expand(B, N, 3))
    n_detail = n_course - agent_idx
    i = steps.to(dtype)
    v = ego[:, 2:3]
    accel_dl = dt * torch.clamp(v + mpc_cfg.max_accel * (i + 1.0), max=mpc_cfg.max_speed)
    flat_dl = torch.full((B, N), dt * mpc_cfg.max_speed, dtype=dtype, device=dev)
    res_dl = torch.where(v < mpc_cfg.max_speed, accel_dl, flat_dl)
    valid_suffix = steps[None, :] < n_detail[:, None]
    keep = resample_mask(detail, res_dl, valid_suffix, keep_last=True)
    ego_traj, n_ego = compact_by_mask(detail, keep, cfg.n_frames)
    return detail, n_detail, ego_traj, n_ego


def ego_subtick_pre(
    course, n_course, dl, goal_xy, ego, ctrl: ControllerState,
    cutoff_len, agent_idx, first_tick, done, preds, preds_active,
    cfg: EngineConfig, geom: VehicleGeometry,
):
    """Everything before the MPC solve, for a batch: goal test, localization
    advance, reachability resample, conflict scan, cutoff / speed-zero
    decision. course (B, N, 3), preds (B, n_obs, n_pred, 3); the rest (B,...).
    Returns (done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv)."""
    mpc_cfg = cfg.mpc
    B, N = course.shape[:2]
    dtype, dev = course.dtype, course.device
    circle_centers = torch.as_tensor(geom.circle_centers, dtype=dtype, device=dev)
    steps = torch.arange(N, device=dev)

    # 1. goal test against the PREVIOUS tick's controller/cutoff state
    done_now = done | is_goal(ego, goal_xy, ctrl.target_idx, cutoff_len, mpc_cfg)

    # 2. driver-side localization advance, frozen when the cut course has
    #    already collapsed onto the agent (reference :100-105)
    tip = take_rows(course, torch.clamp(cutoff_len - 1, min=0))
    collapsed = (take_rows(course, agent_idx) == tip).all(-1)
    advance = first_tick | ~collapsed
    agent_idx = torch.where(
        advance,
        nearest_index_in_direction(ego[:, :2], course[:, :, :2], agent_idx, n_course,
                                   forward=True),
        agent_idx)

    # 3. ego reachability resample of the suffix (reference :110-116)
    detail, n_detail, ego_traj, n_ego = resample_suffix(course, n_course, ego, agent_idx, cfg)

    # 5. conflict scan (reference :125-126)
    scan = check_collision_moving_cars(
        ego_traj, n_ego, detail, n_detail, preds, preds_active, circle_centers,
        geom.radius, cfg.frame_window, cfg.n_frames)

    # 6. cutoff (reference :129-136): margin of ~a car length
    margin = 4 * torch.ceil(geom.radius / dl).to(torch.int32)
    cut_found, cut_idx = cutoff_index_by_position(course, n_course, scan.xy)
    use_cut = scan.found & cut_found
    cut = torch.maximum(agent_idx + 1, cut_idx - margin)
    cutoff_len = torch.where(use_cut, cut, n_course)

    if cfg.yield_by_speed:
        # speed-reference yielding: keep the full path, zero the reference
        # speed from the cutoff on (mpc_with_speed.py:275-282)
        course_len_for_mpc = n_course
        cv = torch.where(steps[None, :] < cutoff_len[:, None],
                         torch.full((B, N), mpc_cfg.target_speed, dtype=dtype, device=dev),
                         torch.zeros((B, N), dtype=dtype, device=dev))
    else:
        course_len_for_mpc = cutoff_len
        cv = torch.zeros((B, N), dtype=dtype, device=dev)

    return done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv


def ego_subtick_post(
    course, ego, ctrl: ControllerState, done_now, agent_idx, scan: CollisionScan,
    cutoff_len, out, cfg: EngineConfig, geom: VehicleGeometry,
):
    """Everything after the MPC solve, for a batch: plant step,
    freeze-on-done, telemetry."""
    mpc_cfg = cfg.mpc
    limits = SimLimits(max_steer=mpc_cfg.max_steer, max_speed=mpc_cfg.max_speed,
                       min_speed=mpc_cfg.min_speed)

    dev = xref_deviation(ego, course, out.target_idx)
    new_ego = plant_step(ego, torch.stack([out.accel, out.steer], dim=-1), mpc_cfg.dt,
                         geom.wheelbase, limits)

    def frz(new, old):
        return torch.where(done_now.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

    ego_out = frz(new_ego, ego)
    ctrl_out = ControllerState(*(frz(a, b) for a, b in zip(out.state, ctrl)))
    zero = torch.zeros_like(out.accel)
    tel = Telemetry(
        x=ego_out[:, 0], y=ego_out[:, 1], yaw=ego_out[:, 3], v=ego_out[:, 2],
        accel=torch.where(done_now, zero, out.accel),
        steer=torch.where(done_now, zero, out.steer),
        xref_dev=dev,
        solved=out.solved | done_now,
        collision_found=scan.found & ~done_now,
        collision_xy=scan.xy,
        cutoff_len=cutoff_len,
        done=done_now,
    )
    return (ego_out, ctrl_out, cutoff_len, agent_idx, done_now), tel


def tree_map(fn, t):
    """``fn`` on every tensor of a tensor, or of (named) tuples of them."""
    if isinstance(t, tuple):
        items = [tree_map(fn, v) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    return fn(t)


def tree_stack(items):
    """Stack a list of equal trees of tensors along a new leading axis."""
    first = items[0]
    if isinstance(first, tuple):
        fields = [tree_stack(list(f)) for f in zip(*items)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)
    return torch.stack(items)


def _lead(t):
    """A leading batch axis of 1 on a tensor or a (named) tuple of them."""
    return tree_map(lambda v: v[None], t)


def _unlead(t):
    """The reverse of ``_lead``."""
    return tree_map(lambda v: v[0], t)


def ego_subtick(
    course,            # (N, 3) padded course for this ego
    n_course,          # () int32
    dl,                # ()
    goal_xy,           # (2,)
    ego,               # (4,)
    ctrl: ControllerState,   # unbatched
    cutoff_len,        # () int32, previous tick's
    agent_idx,         # () int32, previous tick's
    first_tick,        # () bool
    done,              # () bool
    preds,             # (n_obs, n_pred, 3) predicted obstacle trajectories
    preds_active,      # (n_obs,) bool
    cfg: EngineConfig,
    geom: VehicleGeometry,
):
    """One ego's control tick given its obstacles' predictions: the batched
    ``ego_subtick_pre`` -> ``mpc_step_batched`` -> ``ego_subtick_post`` at
    B=1 (one K1 and one K2 launch on the card). The multi-ego engine's
    per-ego tick (obstacles = the other egos + scripted traffic).
    Returns ((ego, ctrl, cutoff_len, agent_idx, done_now), Telemetry)."""
    (course, n_course, dl, goal_xy, ego, ctrl, cutoff_len, agent_idx, first_tick, done, preds,
     preds_active) = _lead((course, n_course, dl, goal_xy, ego, ctrl, cutoff_len, agent_idx,
                            first_tick, done, preds, preds_active))
    done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv = ego_subtick_pre(
        course, n_course, dl, goal_xy, ego, ctrl, cutoff_len, agent_idx, first_tick, done, preds,
        preds_active, cfg, geom)
    out = mpc_step_batched(ego, course, cv, course_len_for_mpc, dl, ctrl, cfg.mpc, geom.wheelbase)
    new, tel = ego_subtick_post(course, ego, ctrl, done_now, agent_idx, scan, cutoff_len, out,
                                cfg, geom)
    return _unlead(new), _unlead(tel)


def engine_tick(world: WorldArrays, st: EngineState, cfg: EngineConfig, geom: VehicleGeometry):
    """One tick of one scenario: ``engine_tick_fleet`` at B=1 (the scripted
    agents' predictions once, the ego's subtick, the agents' step, every
    field frozen once the scenario is done: QUIRKS #21). Returns (state,
    Telemetry)."""
    from .fleet import engine_tick_fleet   # fleet.py imports this module

    new, tel = engine_tick_fleet(_lead(world), _lead(st), cfg, geom)
    return _unlead(new), _unlead(tel)


def run_episode(world: WorldArrays, state0: EngineState, cfg: EngineConfig,
                geom: VehicleGeometry, n_steps: int):
    """``n_steps`` ticks of one scenario, finished or not (the JAX
    package's ``lax.scan``): ``run_fleet_episodes`` at B=1. Returns (final
    state, Telemetry with every field stacked (n_steps, ...))."""
    from .fleet import run_fleet_episodes   # fleet.py imports this module

    final, tel = run_fleet_episodes(_lead(world), _lead(state0), cfg, geom, n_steps)
    return _unlead(final), tree_map(lambda v: v[:, 0], tel)
