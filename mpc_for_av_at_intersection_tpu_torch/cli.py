"""Command-line interface.

Port of ``mpc_for_av_at_intersection_tpu/cli.py``: the same subcommands,
options, defaults and JSON keys.

    python -m mpc_for_av_at_intersection_tpu_torch run --driver intersection
    python -m mpc_for_av_at_intersection_tpu_torch plan --env roundabout --start 1 --turn 1
    python -m mpc_for_av_at_intersection_tpu_torch fleet --n 256 --steps 200
    python -m mpc_for_av_at_intersection_tpu_torch sweep --param w_perp --values 1,5,20
    python -m mpc_for_av_at_intersection_tpu_torch bench

Two choices of the JAX CLI have no torch meaning, and are made here so:

- The device. The JAX CLI takes its platform from ``JAX_PLATFORMS``; every
  subcommand here takes ``--device {cuda,cpu}``, ``cuda`` by default. With
  ``cuda`` and no card the CLI exits non-zero with a message; it never
  carries on on the CPU. ``bench`` measures the card, so it takes ``cuda``
  only.
- ``fleet``. The JAX CLI picks the fleet engine on a TPU and a vmap of the
  single-scenario episode elsewhere (``fast``), and shards when it sees
  several devices. The port always runs the fleet engine (its single-scenario
  episode is the fleet engine at B=1). ``--shard`` shards the batch over the
  ranks of a process group when launched under torchrun (one rank a card:
  ``torchrun --nproc-per-node=4 -m mpc_for_av_at_intersection_tpu_torch --
  fleet --shard``, the ``--`` ending torchrun's own options; rank 0 prints
  the summary of the whole fleet); without torchrun it runs on one device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _numpy(tel):
    from .engine.closed_loop import tree_map

    return tree_map(lambda t: t.cpu().numpy(), tel)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cmd_run(args):
    import numpy as np

    from . import api
    from .engine import run_episode

    builders = {
        "intersection": api.build_intersection,
        "t_intersection": api.build_t_intersection_basic,
        "roundabout": api.build_roundabout,
        "multi_lane": api.build_intersection_multi_lane,
        "speed_ref": api.build_intersection_speed_ref,
        "overtaking": api.build_overtaking_cyclist,
    }
    setup = builders[args.driver](device=args.device)
    t0 = time.perf_counter()
    if args.live or args.live_save:
        # reference-style frame-by-frame loop (mpc_intersection.py:150):
        # one engine tick per iteration, rendered as it happens
        from .engine import run_episode_live
        from .utils.plotting import LiveView

        view = LiveView(
            setup.scenario, setup.geom, trajectory=setup.trajectory,
            dt=setup.cfg.mpc.dt, save_dir=args.live_save,
        )
        final, tel = run_episode_live(
            setup.world, setup.state0, setup.cfg, setup.geom, args.steps,
            on_tick=view,
        )
        view.close()
    else:
        final, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, args.steps)
        tel = _numpy(tel)
    _sync(args.device)
    dt = time.perf_counter() - t0

    k = int(final.ticks_to_goal)
    out = {
        "driver": args.driver,
        "done": bool(final.done),
        "ticks_to_goal": k,
        "sim_seconds": k * setup.cfg.mpc.dt,
        "wall_seconds": round(dt, 3),
        "unsolved_ticks": int((~tel.solved).sum()),
        "conflicts_detected": int(tel.collision_found.sum()),
        "max_xref_deviation": float(np.nanmax(tel.xref_dev[: max(k, 1)])),
    }
    print(json.dumps(out, indent=2))

    if args.save_telemetry:
        np.savez(args.save_telemetry, **tel._asdict())
        print(f"telemetry -> {args.save_telemetry}", file=sys.stderr)
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")

        from .utils import plot_telemetry

        axes = plot_telemetry(tel, dt=setup.cfg.mpc.dt)
        axes[0].figure.savefig(args.plot, dpi=120)
        print(f"plot -> {args.plot}", file=sys.stderr)


def _cmd_plan(args):
    from .lattice import MotionPrimitiveSearch, primitive_table
    from .models import bicycle_geometry, prius_geometry
    from .worlds import (
        arterial_multi_lanes,
        intersection,
        intersection_multi_lanes,
        roundabout,
        roundabout_big,
        t_intersection,
    )

    envs = {
        "intersection": lambda: intersection(args.turn, args.start),
        "t_intersection": lambda: t_intersection(args.turn, args.start),
        "roundabout": lambda: roundabout(args.turn, args.start),
        "roundabout_big": lambda: roundabout_big(args.turn, args.start),
        "multi_lane": lambda: intersection_multi_lanes(args.turn, args.start),
        "arterial": lambda: arterial_multi_lanes(),
    }
    sc = envs[args.env]()
    geom = prius_geometry() if args.vehicle == "prius" else bicycle_geometry()
    table = primitive_table(geom)

    # host code: the lattice search runs on the CPU whatever --device says
    t0 = time.perf_counter()
    if args.backend == "native":
        from .native import NativeMotionPrimitiveSearch, native_available

        if not native_available():
            print("native core unavailable; falling back to python", file=sys.stderr)
            args.backend = "python"
    if args.backend == "native":
        search = NativeMotionPrimitiveSearch(sc, geom, table, margin=geom.radius)
        cost, path, traj = search.run()
        n_exp = search.n_expanded
    else:
        search = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius)
        cost, path, traj = search.run(debug=True)
        n_exp = len(search.debug_data)
    dt = time.perf_counter() - t0

    print(json.dumps({
        "env": args.env, "cost": round(cost, 4), "path_nodes": len(path),
        "trajectory_points": len(traj), "expansions": n_exp,
        "runtime_ms": round(dt * 1e3, 2), "backend": args.backend,
    }, indent=2))


def _cmd_fleet(args):
    import numpy as np

    from . import api
    from .engine import EngineConfig
    from .parallel import batch_mesh, run_batch_episodes

    mesh, rank, device = None, 0, args.device
    if args.shard and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from .parallel.distributed import initialize_process, local_device

        initialize_process(device=args.device)
        mesh, rank, device = batch_mesh(args.device), dist.get_rank(), local_device(args.device)
    try:
        rng = np.random.default_rng(args.seed)
        t0 = time.perf_counter()
        if args.geom:
            geom, wb, sb, meta = api.sample_intersection_fleet_geom(
                args.n, rng, n_steps=args.steps, planner=args.planner, device=device
            )
        else:
            geom, wb, sb, meta = api.sample_intersection_fleet_batched(
                args.n, rng, n_steps=args.steps, planner=args.planner, device=device
            )
        t_plan = time.perf_counter() - t0

        _sync(device)
        t0 = time.perf_counter()
        final, tel, summary = run_batch_episodes(
            wb, sb, EngineConfig(), geom, args.steps, mesh=mesh
        )
        summary = {k: int(v) for k, v in summary.items()}   # the fetch ends the bracket
        t_run = time.perf_counter() - t0
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()

    if rank == 0:
        print(json.dumps({
            "n_scenarios": args.n,
            "n_done": summary["n_done"],
            "unsolved_ticks": summary["n_unsolved_ticks"],
            "mean_ticks_to_goal": float(summary["ticks_to_goal_sum"]) / args.n,
            "planner": args.planner,
            "plan_seconds": round(t_plan, 2),
            "run_seconds": round(t_run, 2),
            "scenario_ticks_per_second": round(args.n * args.steps / t_run, 1),
            "devices": mesh.size() if mesh is not None else 1,
        }, indent=2))


def _cmd_sweep(args):
    from . import api, sweep

    values = [float(v) for v in args.values.split(",")]
    recs = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg, device=args.device),
        args.param, values, n_steps=args.steps,
    )
    print(json.dumps([
        {
            "value": r.value, "done": r.done, "ticks_to_goal": r.ticks_to_goal,
            "max_deviation": round(r.max_deviation, 4),
            "mean_abs_accel": round(r.mean_abs_accel, 4),
        }
        for r in recs
    ], indent=2))


def _cmd_bench(args):
    from . import bench

    if args.device != "cuda":
        sys.exit("bench: the bench measures the card; it takes --device cuda only")
    rc = bench.main()
    if rc:
        sys.exit(rc)


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the tensors live (default: the card)")

    p = argparse.ArgumentParser(prog="mpc_for_av_at_intersection_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", parents=[common], help="run one closed-loop driver scenario")
    r.add_argument("--driver", default="intersection",
                   choices=["intersection", "t_intersection", "roundabout",
                            "multi_lane", "speed_ref", "overtaking"])
    r.add_argument("--steps", type=int, default=256)
    r.add_argument("--save-telemetry", default=None)
    r.add_argument("--plot", default=None)
    r.add_argument("--live", action="store_true",
                   help="render every control tick as it runs "
                        "(reference-style live animation; needs a display)")
    r.add_argument("--live-save", default=None, metavar="DIR",
                   help="live per-tick rendering, frames streamed to DIR "
                        "(headless equivalent of --live)")
    r.set_defaults(fn=_cmd_run)

    pl = sub.add_parser("plan", parents=[common], help="global lattice plan only")
    pl.add_argument("--env", default="intersection")
    pl.add_argument("--start", type=int, default=4)
    pl.add_argument("--turn", type=int, default=1)
    pl.add_argument("--vehicle", default="bicycle", choices=["bicycle", "prius"])
    pl.add_argument("--backend", default="native", choices=["native", "python"])
    pl.set_defaults(fn=_cmd_plan)

    f = sub.add_parser("fleet", parents=[common], help="Monte-Carlo batched fleet run")
    f.add_argument("--n", type=int, default=64)
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--shard", action="store_true",
                   help="shard over the ranks of a torchrun launch")
    f.add_argument("--planner", default="native",
                   choices=["native", "device", "host"],
                   help="global planner: host C++ core, batched device "
                        "search (K3), or Python host search")
    f.add_argument("--geom", action="store_true",
                   help="sample per-scenario junction GEOMETRY (road / "
                        "median / corner radius) — every scenario gets a "
                        "unique junction; use --planner device at scale")
    f.set_defaults(fn=_cmd_fleet)

    s = sub.add_parser("sweep", parents=[common], help="MPC weight sensitivity sweep")
    s.add_argument("--param", default="w_perp")
    s.add_argument("--values", default="1,5,20")
    s.add_argument("--steps", type=int, default=200)
    s.set_defaults(fn=_cmd_sweep)

    b = sub.add_parser("bench", parents=[common], help="run the headline benchmark")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("--device cuda: no CUDA device is available "
                    "(pass --device cpu to run on the CPU)")
    args.fn(args)


if __name__ == "__main__":
    main()
