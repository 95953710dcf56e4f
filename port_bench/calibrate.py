"""Readings that the limits of ``correct`` are set from, for one cell:
the program's numbers on each of ``--seeds``, the control's on each of
``--control-seeds`` and a planted fault's on each of ``--fault-seeds``,
one episode a seed, all in one process (the set-up of the card and the
kernels once).

    python3 -m port_bench.calibrate --workload T13.fleet10000 --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 4,5,6

The control is the reference computed in bfloat16, one precision below
the configuration's float32, put in the program's place for the same
sampled rows of the same ticks (``judge.judge(control=True)``). The fault
(``unsolved_half``) flips the solver's report to unsolved on every other
row where the tick calls it (the commands it returns are left as they
are).
Prints one JSON line a seed and reading. Not run by the benchmark's own
runs.
"""

import argparse
import json
import sys
import time


def unsolved_half(kind):
    """Plants the fault: every other row of each solve comes back
    unsolved. Returns a function that takes it out again."""
    import importlib

    mod_name, fns = kind.SOLVER_SITES
    mod = importlib.import_module(f"mpc_for_av_at_intersection_tpu_torch.{mod_name}")
    saved = {fn: getattr(mod, fn) for fn in fns}

    def wrap(step):
        def broken(*a, **k):
            out = step(*a, **k)
            solved = out.solved.clone()
            solved.view(-1)[::2] = False
            return out._replace(solved=solved)
        return broken

    for fn, step in saved.items():
        setattr(mod, fn, wrap(step))

    def undo():
        for fn, step in saved.items():
            setattr(mod, fn, step)
    return undo


def readings(name, seed, device, control, cell=None):
    """({"program": numbers, "control": numbers or None}) of one episode."""
    import torch

    from port_bench import generator, harness, judge, spec

    cell = cell or spec.cell(name)
    fleet = generator.build(cell["traffic"], cell["config"], seed, device)
    draws = judge.draw(cell["check"], fleet.episode_ticks, fleet.rows, seed)
    _, captures = harness.run_window(fleet, float("inf"), draws, device,
                                     max_ticks=fleet.episode_ticks)
    world, kind = fleet.world, fleet.kind
    del fleet
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"program": judge.judge(kind, world, captures, draws, cell["config"], device)}
    out["control"] = (judge.judge(kind, world, captures, draws, cell["config"], device,
                                  control=True) if control else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(control - set(seeds)):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, device, seed in control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "program": r["program"] if seed in seeds else None,
                          "control": r["control"]}), flush=True)
    from port_bench import spec

    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        t0 = time.perf_counter()
        undo = unsolved_half(spec.kind(spec.cell(args.workload)["traffic"]["kind"]))
        try:
            r = readings(args.workload, seed, device, False)
        finally:
            undo()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "fault": "unsolved_half", "program": r["program"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
