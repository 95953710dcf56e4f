"""Fleet engine: batched closed-loop ticks around the kernel solver.

Port of ``mpc_for_av_at_intersection_tpu/engine/fleet.py``: the tick is
split around the solver — ``ego_subtick_pre`` over the batch ->
``mpc_step_batched`` (kernels K1 and K2 on the card) ->
``ego_subtick_post`` — and an episode is a Python loop over ticks.
``use_kernels=False`` runs the solver's plain versions wherever the tensors
are, as the JAX package's ``use_pallas=False`` does, to time the plain path
on the card. The JAX package's ``pre_chunk`` option (off by default there)
is not carried over: the pre stage runs whole-batch, and the conflict scan
(``agents/collision.py``) slices its own rows to bound the tick's memory.
Under a ``torch.profiler`` session the tick opens the spans
``tick.predict``, ``tick.pre``, ``tick.mpc`` and ``tick.post`` in turn
(``utils/timing.py::span``).
"""

from __future__ import annotations

import torch

from ..agents import agents_get, agents_step, predict_constant_control
from ..models import VehicleGeometry
from ..mpc.batch import _mpc_step, mpc_step_batched
from ..mpc.qp import solve_box_qp_batched
from ..ops.condense_qp import build_qp_reference
from ..utils.timing import span
from .closed_loop import (
    EngineConfig,
    EngineState,
    WorldArrays,
    ego_subtick_post,
    ego_subtick_pre,
    tree_stack,
)


def engine_tick_fleet(world: WorldArrays, st: EngineState, cfg: EngineConfig,
                      geom: VehicleGeometry, use_kernels: bool = True):
    """One tick of every scenario in the batch. Returns (state, Telemetry)."""
    dt = cfg.mpc.dt
    with span("tick.predict"):
        obs6 = agents_get(world.agent_params, st.agents, dt)
        preds = predict_constant_control(obs6, dt, geom.wheelbase, cfg.n_pred)

    with span("tick.pre"):
        done_now, agent_idx, scan, cutoff_len, course_len_for_mpc, cv = ego_subtick_pre(
            world.course, world.n_course, world.dl, world.goal_xy, st.ego, st.ctrl,
            st.cutoff_len, st.agent_idx, st.first_tick, st.done, preds,
            world.agent_params.active, cfg, geom)

    with span("tick.mpc"):
        mpc_args = (st.ego, world.course, cv, course_len_for_mpc, world.dl, st.ctrl, cfg.mpc,
                    geom.wheelbase)
        if use_kernels:
            out = mpc_step_batched(*mpc_args)
        else:
            out = _mpc_step(*mpc_args, build_qp_reference, solve_box_qp_batched)

    with span("tick.post"):
        (ego, ctrl, cutoff_out, aidx_out, _), tel = ego_subtick_post(
            world.course, st.ego, st.ctrl, done_now, agent_idx, scan, cutoff_len, out, cfg,
            geom)

        agents = agents_step(world.agent_params, st.agents, dt, geom.wheelbase)
        agents = type(agents)(*(
            torch.where(done_now.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)
            for new, old in zip(agents, st.agents)))

        new_st = EngineState(
            ego=ego,
            ctrl=ctrl,
            agents=agents,
            cutoff_len=torch.where(done_now, st.cutoff_len, cutoff_out),
            agent_idx=torch.where(done_now, st.agent_idx, aidx_out),
            first_tick=st.first_tick & done_now,
            done=done_now,
            ticks_to_goal=torch.where(done_now & ~st.done, st.tick, st.ticks_to_goal),
            tick=st.tick + 1,
        )
    return new_st, tel


def run_fleet_episodes(world: WorldArrays, state0: EngineState, cfg: EngineConfig,
                       geom: VehicleGeometry, n_steps: int, use_kernels: bool = True):
    """``n_steps`` ticks of the batch. Returns (final state, Telemetry with
    every field stacked (n_steps, B, ...))."""
    st, rows = state0, []
    for _ in range(n_steps):
        st, tel = engine_tick_fleet(world, st, cfg, geom, use_kernels)
        rows.append(tel)
    return st, tree_stack(rows)
