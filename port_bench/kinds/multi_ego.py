"""Traffic kind ``multi_ego``: ``junctions`` junctions of ``lanes`` lanes,
each holding the egos of ``egos`` ((start, turn, lane) each; the courses
planned once by ``planner``); ticked by ``engine.multi_ego_fleet_tick``.

Every ego is placed as the package's ``bench.py`` places its controller
instances: at a course index drawn from ``start_index`` (half-open, as
``numpy``'s ``integers``), with a speed drawn uniform in ``start_speed``
and its x, y and heading moved off the course by normal noise of the
standard deviations in ``start_noise``."""

from __future__ import annotations

import numpy as np
import torch

ENTRY = ("engine", "multi_ego_fleet_tick")
# where the solve is called: on the card, and through the plain versions
# elsewhere
SOLVER_SITES = ("engine.multi_ego", ("mpc_step_batched", "_mpc_step"))
FREEZE_AGENTS_WITH_DONE = False


def build(traffic, cfg, rng, device):
    """(geom, world, state0, tick, rows) of the fleet drawn by ``rng``."""
    from mpc_for_av_at_intersection_tpu_torch import api, engine
    from mpc_for_av_at_intersection_tpu_torch.agents import stack_agents
    from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map
    from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
    from mpc_for_av_at_intersection_tpu_torch.worlds import intersection_multi_lanes

    geom = bicycle_geometry()
    junctions = [intersection_multi_lanes(turn_indicator=t, start_pos=s, start_lane=lane,
                                          goal_lane=lane, number_of_lanes=traffic["lanes"])
                 for s, t, lane in traffic["egos"]]
    courses, _ = api.plan_courses_batch(junctions, geom, planner=traffic["planner"],
                                        device=device)
    params, agents = stack_agents([], n_slots=cfg.n_agents)
    one = engine.make_multi_ego_world(courses, params, cfg, device=device)
    st1 = engine.init_multi_ego_state(one, agents, cfg, traffic["episode_ticks"], device=device)
    S, E = traffic["junctions"], len(traffic["egos"])
    world = tree_map(lambda a: a.expand((S,) + a.shape).contiguous(), one)
    st = tree_map(lambda a: a.expand((S,) + a.shape).contiguous(), st1)

    idx = rng.integers(*traffic["start_index"], size=(S, E))
    speed = rng.uniform(*traffic["start_speed"], size=(S, E))
    noise = rng.normal(0.0, traffic["start_noise"], size=(S, E, 3))
    idx = np.minimum(idx, np.asarray([len(c) - 1 for c in courses])[None])
    idx_t = torch.as_tensor(idx, device=device)
    pose = torch.gather(world.courses, 2, idx_t[..., None, None].expand(S, E, 1, 3))[:, :, 0]
    pose = pose + torch.as_tensor(noise, dtype=pose.dtype, device=device)
    egos = torch.stack([pose[..., 0], pose[..., 1],
                        torch.as_tensor(speed, dtype=pose.dtype, device=device), pose[..., 2]], -1)
    idx32 = idx_t.to(torch.int32)
    st = st._replace(egos=egos, agent_idxs=idx32,
                     ctrls=st.ctrls._replace(target_idx=idx32.clone()))

    def tick(s):
        return engine.multi_ego_fleet_tick(world, s, cfg, geom)

    return geom, world, st, tick, S * E


def shrink(traffic):
    """The mix cut to a few rows, for tests on the CPU."""
    traffic["junctions"] = 2


def gather(world, before, after, tel, rows, device):
    """Inputs and the program's outputs of ``rows`` (junction-major ego
    rows) as plain tensors on ``device``, in the layout ``judge`` hands the
    reference: each sampled ego with its junction's scripted agents and
    all of its egos."""
    r = torch.as_tensor(rows, device=world.courses.device)
    E = before.egos.shape[1]
    s, e = r // E, r % E
    u, inv = torch.unique(s, return_inverse=True)

    def take(t):
        return t[s, e].to(device)

    def junc(t):
        return t[u].to(device)

    ctrl = before.ctrls
    junction = {"agents": {k: junc(getattr(world.agent_params, k))
                           for k in ("policy", "direction", "turning", "speed", "offset",
                                     "x_turn", "active")},
                "egos": junc(before.egos), "last_steer": junc(ctrl.last_steer)}
    junction["agents"].update(pose=junc(before.agents.pose), counter=junc(before.agents.counter))
    inputs = {
        "world": dict(course=take(world.courses), n_course=take(world.n_courses),
                      dl=take(world.dls), goal_xy=take(world.goals_xy)),
        "state": dict(ego=take(before.egos), oa=take(ctrl.oa), od=take(ctrl.od),
                      have_prev=take(ctrl.have_prev), ov=take(ctrl.ov),
                      have_ov=take(ctrl.have_ov), target_idx=take(ctrl.target_idx),
                      cutoff_len=take(before.cutoff_lens), agent_idx=take(before.agent_idxs),
                      first_tick=before.first_tick[s].to(device), done=take(before.done)),
        "junction": junction,
        "rows": torch.stack([inv.cpu(), e.cpu()], 1).to(device),
    }
    out = dict(done=take(tel.done), agent_idx=take(after.agent_idxs),
               cutoff_len=take(tel.cutoff_len), collision_found=take(tel.collision_found),
               accel=take(tel.accel), steer=take(tel.steer), solved=take(tel.solved),
               ego=take(after.egos), agents_pose=junc(after.agents.pose))
    return inputs, out
