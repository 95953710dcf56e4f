"""Traffic kind ``standard_fleet``: ``scenarios`` single-ego junctions
drawn as ``api.sample_intersection_fleet_batched`` draws them (start x
turn, 0-2 scripted cars with drawn turn, speed and offset), the courses of
the unique (start, turn) keys planned by ``planner``; ticked by
``engine.engine_tick_fleet``. A finished row freezes its scenario's
scripted cars."""

from __future__ import annotations

import torch

ENTRY = ("engine", "engine_tick_fleet")           # what the window drives
# where the solve is called: on the card, and through the plain versions
# elsewhere
SOLVER_SITES = ("engine.fleet", ("mpc_step_batched", "_mpc_step"))
FREEZE_AGENTS_WITH_DONE = True


def build(traffic, cfg, rng, device):
    """(geom, world, state0, tick, rows) of the fleet drawn by ``rng``."""
    from mpc_for_av_at_intersection_tpu_torch import api, engine

    geom, world, state0, _ = api.sample_intersection_fleet_batched(
        traffic["scenarios"], rng, cfg=cfg, n_steps=traffic["episode_ticks"],
        starts=tuple(traffic["starts"]), turns=tuple(traffic["turns"]),
        planner=traffic["planner"], device=device)

    def tick(st):
        return engine.engine_tick_fleet(world, st, cfg, geom)

    return geom, world, state0, tick, traffic["scenarios"]


def shrink(traffic):
    """The mix cut to a few rows, for tests on the CPU."""
    traffic["scenarios"] = 6


def gather(world, before, after, tel, rows, device):
    """Inputs and the program's outputs of ``rows`` as plain tensors on
    ``device``, in the layout ``judge`` hands the reference."""
    r = torch.as_tensor(rows, device=world.course.device)

    def take(t):
        return t[r].to(device)

    ctrl = before.ctrl
    junction = {"agents": {k: take(getattr(world.agent_params, k))
                           for k in ("policy", "direction", "turning", "speed", "offset",
                                     "x_turn", "active")}}
    junction["agents"].update(pose=take(before.agents.pose), counter=take(before.agents.counter))
    inputs = {
        "world": dict(course=take(world.course), n_course=take(world.n_course),
                      dl=take(world.dl), goal_xy=take(world.goal_xy)),
        "state": dict(ego=take(before.ego), oa=take(ctrl.oa), od=take(ctrl.od),
                      have_prev=take(ctrl.have_prev), ov=take(ctrl.ov),
                      have_ov=take(ctrl.have_ov), target_idx=take(ctrl.target_idx),
                      cutoff_len=take(before.cutoff_len), agent_idx=take(before.agent_idx),
                      first_tick=take(before.first_tick), done=take(before.done)),
        "junction": junction,
        "rows": torch.stack([torch.arange(len(rows)), torch.full((len(rows),), -1)],
                            1).to(device),
    }
    out = dict(done=take(tel.done), agent_idx=take(after.agent_idx),
               cutoff_len=take(tel.cutoff_len), collision_found=take(tel.collision_found),
               accel=take(tel.accel), steer=take(tel.steer), solved=take(tel.solved),
               ego=take(after.ego), agents_pose=take(after.agents.pose))
    return inputs, out
