"""Multi-ego interactive mode: E vehicles each running the full bi-level
stack, predicting each other.

Port of ``mpc_for_av_at_intersection_tpu/engine/multi_ego.py`` (the
capability reference ``main/scenarios/interactive_mpc.py`` intended; its
committed code cannot run, SURVEY section 2.11). The egos are a batch axis
within the junction: every ego plans against the OTHER egos' start-of-tick
states at once (decentralized, prediction-based, no negotiation), and all
plants step together. Each ego treats the other egos and the scripted
agents alike as predicted obstacles.

Peer egos are predicted by a constant-control rollout of (x, y, v, yaw,
a=0, steer=last commanded): QUIRKS #5, the reference's
``OtherAgentsPrediction`` doubles the peer's speed every step, a bug in
code that never ran.

Three ticks, as in the JAX package:
- ``multi_ego_tick``: one junction, each ego's subtick on its own
  (``ego_subtick`` at B=1: on the card E launches of K1 and K2 a tick);
- ``multi_ego_tick_batched``: one junction, the E egos' QPs in one
  ``mpc_step_batched`` call;
- ``multi_ego_fleet_tick``: S junctions stacked along a leading axis, all
  S·E QPs in one call.
``use_kernels=None`` runs the kernels iff the tensors are on a CUDA device;
``False`` runs the solver's plain versions wherever the tensors are (to
time the plain path on the card). The JAX package's chunked pre stage
(``pre_chunk_egos``, ``engine/fleet.py::best_pre_chunk``) worked around an
XLA fusion failure that eager PyTorch does not have, and is left out: the
pre stage runs over all S·E rows at once.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..agents import AgentParams, AgentStates, agents_get, agents_step, predict_constant_control
from ..models import VehicleGeometry
from ..mpc.batch import _mpc_step, mpc_step_batched
from ..mpc.controller import CUDA, ControllerState, init_controller_state
from ..mpc.qp import solve_box_qp_batched
from ..ops.condense_qp import build_qp_reference
from .closed_loop import (
    EngineConfig,
    _agents_to_torch,
    _lead,
    _unlead,
    ego_subtick,
    ego_subtick_post,
    ego_subtick_pre,
    make_world,
    tree_map,
    tree_stack,
)


class MultiEgoWorld(NamedTuple):
    courses: torch.Tensor       # (E, N, 3)
    n_courses: torch.Tensor     # (E,) int32
    dls: torch.Tensor           # (E,)
    goals_xy: torch.Tensor      # (E, 2)
    agent_params: AgentParams   # scripted traffic, (A,) padded


class MultiEgoState(NamedTuple):
    egos: torch.Tensor          # (E, 4)
    ctrls: ControllerState      # fields stacked along E
    agents: AgentStates         # scripted traffic
    cutoff_lens: torch.Tensor   # (E,) int32
    agent_idxs: torch.Tensor    # (E,) int32
    first_tick: torch.Tensor    # () bool, one flag for the junction
    done: torch.Tensor          # (E,) bool
    ticks_to_goal: torch.Tensor  # (E,) int32
    tick: torch.Tensor          # () int32


def make_multi_ego_world(trajectories: List[np.ndarray], agent_params: AgentParams,
                         cfg: EngineConfig, dtype=torch.float32, device=CUDA) -> MultiEgoWorld:
    """One junction's world: each ego's course padded as ``make_world``
    pads it, the scripted agents shared."""
    worlds = [make_world(t, agent_params, cfg, dtype, device) for t in trajectories]
    return MultiEgoWorld(
        courses=torch.stack([w.course for w in worlds]),
        n_courses=torch.stack([w.n_course for w in worlds]),
        dls=torch.stack([w.dl for w in worlds]),
        goals_xy=torch.stack([w.goal_xy for w in worlds]),
        agent_params=worlds[0].agent_params,
    )


def init_multi_ego_state(world: MultiEgoWorld, agent_states: AgentStates, cfg: EngineConfig,
                         n_steps: int, dtype=torch.float32, device=CUDA) -> MultiEgoState:
    """Cold state of one junction: every ego at rest on its course start."""
    courses = world.courses.to(device)
    E = courses.shape[0]
    egos = torch.cat([courses[:, 0, :2], torch.zeros((E, 1), dtype=courses.dtype, device=device),
                      courses[:, 0, 2:3]], dim=1).to(dtype)
    return MultiEgoState(
        egos=egos,
        ctrls=init_controller_state(cfg.mpc, dtype, device=device, batch=E),
        agents=_agents_to_torch(AgentStates, agent_states, dtype, device),
        cutoff_lens=world.n_courses.to(device),
        agent_idxs=torch.zeros((E,), dtype=torch.int32, device=device),
        first_tick=torch.tensor(True, device=device),
        done=torch.zeros((E,), dtype=torch.bool, device=device),
        ticks_to_goal=torch.full((E,), n_steps, dtype=torch.int32, device=device),
        tick=torch.tensor(0, dtype=torch.int32, device=device),
    )


def _predictions(world: MultiEgoWorld, st: MultiEgoState, cfg: EngineConfig,
                 geom: VehicleGeometry):
    """Every ego's (constant speed, last steer, a=0) and every scripted
    agent's prediction, (..., E + A, n_pred, 3), and each ego's active
    mask over them, (..., E, E + A): all egos but itself, and the active
    scripted agents."""
    dt = cfg.mpc.dt
    egos = st.egos
    E = egos.shape[-2]
    ego_obs6 = torch.stack([egos[..., 0], egos[..., 1], egos[..., 2], egos[..., 3],
                            torch.zeros_like(egos[..., 0]), st.ctrls.last_steer], dim=-1)
    scripted_obs6 = agents_get(world.agent_params, st.agents, dt)
    preds = predict_constant_control(torch.cat([ego_obs6, scripted_obs6], dim=-2), dt,
                                     geom.wheelbase, cfg.n_pred)
    peers = ~torch.eye(E, dtype=torch.bool, device=egos.device)
    scripted = world.agent_params.active[..., None, :]
    lead = scripted.shape[:-2]
    active = torch.cat([peers.expand(lead + (E, E)),
                        scripted.expand(lead + (E, scripted.shape[-1]))], dim=-1)
    return preds, active


def _flat(t):
    """(S, E, ...) -> (S·E, ...), on a tensor or a NamedTuple of tensors."""
    return tree_map(lambda v: v.reshape((-1,) + v.shape[2:]), t)


def _multi_ego_pre(world: MultiEgoWorld, st: MultiEgoState, cfg: EngineConfig,
                   geom: VehicleGeometry):
    """Everything before the QP for S junctions (fields with a leading S
    axis): the predictions, then ``ego_subtick_pre`` over the S·E egos.
    The junction's predictions are shared by its egos: expanded over them,
    and materialized once per ego only where S > 1 makes the flat S·E row
    axis a copy. Returns ``ego_subtick_pre``'s tuple over S·E rows."""
    S, E = st.egos.shape[:2]
    preds, active = _predictions(world, st, cfg, geom)          # (S, O, P, 3), (S, E, O)
    preds = preds[:, None].expand((S, E) + preds.shape[1:])
    return ego_subtick_pre(
        _flat(world.courses), _flat(world.n_courses), _flat(world.dls), _flat(world.goals_xy),
        _flat(st.egos), _flat(st.ctrls), _flat(st.cutoff_lens), _flat(st.agent_idxs),
        st.first_tick[:, None].expand(S, E).reshape(-1), _flat(st.done), _flat(preds),
        _flat(active), cfg, geom)


def _multi_ego_post(world: MultiEgoWorld, st: MultiEgoState, pre, out, cfg: EngineConfig,
                    geom: VehicleGeometry):
    """Everything after the QP for S junctions: plant steps, freeze on
    done (the egos only: scripted agents keep moving), telemetry (S, E),
    the scripted agents' step and the new state."""
    S, E = st.egos.shape[:2]
    done_now, agent_idx, scan, cutoff_len, _, _ = pre
    (egos, ctrls, cutoffs, aidxs, done_out), tel = ego_subtick_post(
        _flat(world.courses), _flat(st.egos), _flat(st.ctrls), done_now, agent_idx, scan,
        cutoff_len, out, cfg, geom)

    egos, ctrls, cutoffs, aidxs, done_out, tel = tree_map(
        lambda v: v.reshape((S, E) + v.shape[1:]), (egos, ctrls, cutoffs, aidxs, done_out, tel))
    agents = agents_step(world.agent_params, st.agents, cfg.mpc.dt, geom.wheelbase)
    new_st = MultiEgoState(
        egos=egos,
        ctrls=ctrls,
        agents=agents,
        cutoff_lens=torch.where(done_out, st.cutoff_lens, cutoffs),
        agent_idxs=torch.where(done_out, st.agent_idxs, aidxs),
        first_tick=torch.zeros_like(st.first_tick),
        done=done_out,
        ticks_to_goal=torch.where(done_out & ~st.done, st.tick[:, None], st.ticks_to_goal),
        tick=st.tick + 1,
    )
    return new_st, tel


def multi_ego_fleet_tick(world: MultiEgoWorld, st: MultiEgoState, cfg: EngineConfig,
                         geom: VehicleGeometry, use_kernels=None):
    """S independent junctions in one tick (every field with a leading S
    axis): the pre stage over all S·E egos, ALL S·E QPs in one
    ``mpc_step_batched`` call (one K1 and one K2 launch on the card), the
    post stage. The throughput configuration of BASELINE config 4.
    Returns (state, Telemetry with fields (S, E))."""
    if use_kernels is None:
        use_kernels = st.egos.is_cuda
    pre = _multi_ego_pre(world, st, cfg, geom)
    _, _, _, _, course_len_for_mpc, cv = pre
    args = (_flat(st.egos), _flat(world.courses), cv, course_len_for_mpc, _flat(world.dls),
            _flat(st.ctrls), cfg.mpc, geom.wheelbase)
    if use_kernels:
        out = mpc_step_batched(*args)
    else:
        out = _mpc_step(*args, build_qp_reference, solve_box_qp_batched)
    return _multi_ego_post(world, st, pre, out, cfg, geom)


def multi_ego_tick_batched(world: MultiEgoWorld, st: MultiEgoState, cfg: EngineConfig,
                           geom: VehicleGeometry, use_kernels=None):
    """``multi_ego_tick``'s semantics with the junction's E QPs solved in one
    ``mpc_step_batched`` call: ``multi_ego_fleet_tick`` at S=1. Preferred
    at E >= 8."""
    new, tel = multi_ego_fleet_tick(_lead(world), _lead(st), cfg, geom, use_kernels)
    return _unlead(new), _unlead(tel)


def multi_ego_tick(world: MultiEgoWorld, st: MultiEgoState, cfg: EngineConfig,
                   geom: VehicleGeometry):
    """One tick of one junction, each ego's subtick on its own against the
    shared predictions (the JAX package's vmapped ``ego_subtick``)."""
    preds, active = _predictions(world, st, cfg, geom)
    E = st.egos.shape[0]
    news, tels = [], []
    for e in range(E):
        new, tel = ego_subtick(
            world.courses[e], world.n_courses[e], world.dls[e], world.goals_xy[e], st.egos[e],
            ControllerState(*(f[e] for f in st.ctrls)), st.cutoff_lens[e], st.agent_idxs[e],
            st.first_tick, st.done[e], preds, active[e], cfg, geom)
        news.append(new)
        tels.append(tel)

    egos, ctrls, cutoffs, aidxs, done_now = tree_stack(news)
    agents = agents_step(world.agent_params, st.agents, cfg.mpc.dt, geom.wheelbase)
    new_st = MultiEgoState(
        egos=egos,
        ctrls=ctrls,
        agents=agents,
        cutoff_lens=torch.where(done_now, st.cutoff_lens, cutoffs),
        agent_idxs=torch.where(done_now, st.agent_idxs, aidxs),
        first_tick=torch.zeros_like(st.first_tick),
        done=done_now,
        ticks_to_goal=torch.where(done_now & ~st.done, st.tick, st.ticks_to_goal),
        tick=st.tick + 1,
    )
    return new_st, tree_stack(tels)


def run_multi_ego_episode(world: MultiEgoWorld, state0: MultiEgoState, cfg: EngineConfig,
                          geom: VehicleGeometry, n_steps: int, batched=None, use_kernels=None):
    """``n_steps`` ticks of one junction. ``batched=None`` takes
    ``multi_ego_tick_batched`` at E >= 8 egos and ``multi_ego_tick`` below;
    ``use_kernels`` as in ``multi_ego_fleet_tick`` (the per-ego tick runs
    the kernels iff the tensors are on CUDA). Returns (final state,
    Telemetry with every field stacked (n_steps, E))."""
    if batched is None:
        batched = int(world.courses.shape[0]) >= 8
    st, rows = state0, []
    for _ in range(n_steps):
        if batched:
            st, tel = multi_ego_tick_batched(world, st, cfg, geom, use_kernels)
        else:
            st, tel = multi_ego_tick(world, st, cfg, geom)
        rows.append(tel)
    return st, tree_stack(rows)
