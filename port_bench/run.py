"""Run one cell of the PyTorch/CUDA port's benchmark once and print its
result as the last line of standard output.

    python3 -m port_bench.run --workload T13.fleet10000 --seed 7 --seconds 50 --trace 0

From the root of a checkout holding ``BENCHMARK.json``, ``port_bench/``
and the port (``mpc_for_av_at_intersection_tpu_torch``). Needs a CUDA
card: without one, or without the port, it exits non-zero and prints no
result. ``--trace 1`` prints the cell's per-layer metrics, read from a
``torch.profiler`` trace of a few ticks written into the temporary
directory, and the breakdown; ``--trace 0`` its end-to-end metrics. Every
run checks what its window produced against ``reference.py`` and prints
each compared number beside its limit, last on standard error and under
``check`` at the end of the result line. The kernels build once into the
port's ``_build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_for_av_at_intersection_tpu")


def loaded_forbidden():
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level names (the port's name begins with the package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["workload"]["chips"]:
        print(f"port_bench: {args.workload} needs {cell['workload']['chips']} cards, "
              f"{torch.cuda.device_count()} in view", file=sys.stderr)
        return 2
    try:
        import mpc_for_av_at_intersection_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"port_bench: the port is not in this checkout ({e})", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, shown, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                            bool(args.trace), device, T_START, cell)
    bad = loaded_forbidden()
    if bad:
        print(f"port_bench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(result_line(result, shown))
    return 0


def result_line(result: dict, shown: dict) -> str:
    """The last line: the result's keys, then the compared numbers with
    their limits under ``check``, last."""
    return json.dumps({**result, "check": shown})


if __name__ == "__main__":
    sys.exit(main())
