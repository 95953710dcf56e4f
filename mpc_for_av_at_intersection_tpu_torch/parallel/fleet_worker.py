"""Per-process worker for multi-process fleet runs.

Port of ``mpc_for_av_at_intersection_tpu/parallel/fleet_worker.py``. One
process per card under torchrun:

    torchrun --nproc-per-node=4 -m mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker \
        --batch 8 --steps 3

or one line per process with an explicit rendezvous (here two CPU
processes on gloo):

    python -m mpc_for_av_at_intersection_tpu_torch.parallel.fleet_worker \
        --coordinator 127.0.0.1:19731 --num-processes 2 --process-id 0 \
        --device cpu --batch 8 --steps 3

Every process builds the SAME deterministic scenario batch host-side
(seeded), runs its rows of it over the global ``(hosts, chips)`` mesh on its
own device, and prints the all-reduced fleet summary as one JSON line —
identical on all processes, and identical to a single-process run of the
same batch. The JAX worker's ``--emulate-local-devices`` has no torch
meaning (a rank owns one device, ``distributed.initialize_process``); its
place is taken by ``--device`` (``cuda``, the default: NCCL; ``cpu``:
gloo).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..mpc.controller import CUDA


def build_demo_fleet(batch: int, n_steps: int, device=CUDA):
    """The deterministic demo fleet shared by the smoke test and the
    single-process oracle: tiny curved courses + one scripted agent each,
    on ``device``."""
    import numpy as np

    from ..agents import make_t_intersection_agent, stack_agents
    from ..engine import EngineConfig, init_engine_state, make_world
    from ..models import bicycle_geometry
    from ..mpc import MPCConfig
    from .mesh import stack_states, stack_worlds

    cfg = EngineConfig(
        mpc=MPCConfig(admm_rounds=2, admm_iters=8),
        n_traj=64, n_frames=48, n_agents=2, frame_window=4,
    )
    geom = bicycle_geometry()
    t = np.linspace(0.0, 6.0, 60)
    course = np.stack([t, 0.02 * t ** 2, 0.0 * t], axis=1)
    course[:, 2] = np.arctan2(np.gradient(course[:, 1]), np.gradient(course[:, 0]))

    worlds, states = [], []
    for i in range(batch):
        rows = [make_t_intersection_agent(
            direction=1, turning=False, speed=4.0 + i * 0.2, offset=1.0)]
        params, ag = stack_agents(rows, n_slots=cfg.n_agents)
        w = make_world(course, params, cfg, device=device)
        worlds.append(w)
        states.append(init_engine_state(w, ag, cfg, n_steps, device=device))
    return cfg, geom, stack_worlds(worlds), stack_states(states)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .distributed import global_host_chip_mesh, initialize_process, local_device
    from .mesh import run_batch_episodes

    initialize_process(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=args.device,
    )
    try:
        device = local_device(args.device)
        cfg, geom, wb, sb = build_demo_fleet(args.batch, args.steps, device=device)
        mesh = global_host_chip_mesh(args.device)
        _, _, summary = run_batch_episodes(wb, sb, cfg, geom, args.steps, mesh=mesh)
        report = {
            "process_id": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "global_devices": dist.get_world_size(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "device": str(device) if device.type == "cpu" else torch.cuda.get_device_name(device),
            "n_done": int(summary["n_done"]),
            "ticks_to_goal_sum": int(summary["ticks_to_goal_sum"]),
            "n_unsolved_ticks": int(summary["n_unsolved_ticks"]),
        }
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
