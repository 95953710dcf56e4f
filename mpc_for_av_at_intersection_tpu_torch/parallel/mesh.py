"""Batch runs of fleet episodes on one device.

Port of the single-device ``fast=True`` branch of
``mpc_for_av_at_intersection_tpu/parallel/mesh.py::run_batch_episodes``:
the fleet engine over the whole batch, telemetry as (B, T), and the fleet
summary. The multi-device mesh branch is not ported yet, so the port's
``run_batch_episodes`` takes neither ``mesh`` nor ``fast`` (ROADMAP).
"""

from __future__ import annotations

import torch

from ..engine.closed_loop import EngineConfig, EngineState, WorldArrays, tree_stack
from ..engine.fleet import run_fleet_episodes
from ..models import VehicleGeometry


def stack_worlds(worlds) -> WorldArrays:
    """Stack single-scenario worlds along a new leading axis."""
    return tree_stack(list(worlds))


def stack_states(states) -> EngineState:
    """Stack single-scenario engine states along a new leading axis."""
    return tree_stack(list(states))


def run_batch_episodes(world_batch: WorldArrays, state_batch: EngineState, cfg: EngineConfig,
                       geom: VehicleGeometry, n_steps: int):
    """Run a batch of scenarios in lockstep for ``n_steps`` ticks on their
    device (the JAX package's ``fast=True`` branch without a mesh).

    Returns (final_states, telemetry with fields (B, T, ...), summary) where
    summary holds the scenarios finished, the ticks-to-goal sum and the
    unsolved ticks, as 0-d tensors.
    """
    final, tel = run_fleet_episodes(world_batch, state_batch, cfg, geom, n_steps)
    tel = type(tel)(*(t.transpose(0, 1) for t in tel))
    summary = {
        "n_done": final.done.to(torch.int32).sum(),
        "ticks_to_goal_sum": final.ticks_to_goal.sum(),
        "n_unsolved_ticks": (~tel.solved).to(torch.int32).sum(),
    }
    return final, tel, summary
