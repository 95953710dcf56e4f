#!/usr/bin/env python3
"""Where a step of K3 (the serial A* kernel) spends its time, on the card.

Copies ``mpc_for_av_at_intersection_tpu_torch/csrc/astar.cu`` of the package
this script finds first on ``sys.path`` into that package's ``_build/``,
with thread 0's ``clock64()`` read (summed in shared memory) where each
section of the search step ends (found by the source lines that follow it),
builds the copy alone with the package's nvcc flags, and runs it through the
package's own wrapper on ``chip_smoke.py`` phase 8's inputs (1024 sampled
junction geometries, 20,000 expansions). It prints one JSON line: for the
row with the most expansions, the cycles per expansion of each section and
its share, beside the time of the copy and of the package's own kernel. The
package's kernel is not changed; only the copy carries the clock reads.

    python3 k3_step_split.py            # this checkout's kernel

To measure another checkout's kernel, copy this script and ``chip_smoke.py``
beside its package and run it there by path (Python puts the script's
directory first on ``sys.path``).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke

SECTIONS = 8
# Per kernel design: (section, the source line before which the section
# ends). A section's cycles run from the previous stamp to its own; the
# kernel's set-up ends before the step loop.
STAMPS = {
    "heap": [
        ("setup", "  for (int step = 0; step < n.max_exp; ++step) {"),
        ("pop (heap walk)", "      s_flag = kStop;"),
        ("popped cell read, goal test", "    const float cx = s_pos[0], cy = s_pos[1]"),
        ("collision", "    // candidates, one thread per primitive"),
        ("candidates, g prefetch", "    // serial commit over p; an earlier primitive's commit"),
        ("commit", "    // thread 0 pops next; the others wait"),
    ],
    "min tree": [
        ("setup", "  for (int step = 0; step < n.max_exp; ++step) {"),
        ("rescan of marked blocks", "    // pop: the least level-1 key"),
        ("pop (level-1 reduction)", "    // close: the popped cell's g and pose"),
        ("popped cell and block read, goal test",
         "    const float cs = cosf(cth), sn = sinf(cth);"),
        ("collision beside candidates", "    // commit, on lanes p < P of warp 0"),
        ("commit", "    // rescan the marked blocks; each entry"),
    ],
}
DECLARE = "  const int b = blockIdx.x, tid = threadIdx.x"
WRITE_OUT = "  if (tested) atomicAdd(&s_tested"


def instrument(src: str) -> tuple[str, list[str]]:
    """The source with the stamps of the design it matches, and the
    section names in stamp order."""
    for stamps in STAMPS.values():
        anchors = [a for _, a in stamps] + [DECLARE, WRITE_OUT]
        if all(src.count(a) == 1 for a in anchors):
            break
    else:
        raise SystemExit("k3_step_split: astar.cu matches no known step layout")
    names = [name for name, _ in stamps]
    lines = src.splitlines()
    out = []
    for line in lines:
        for i, (_, anchor) in enumerate(stamps):
            if line.startswith(anchor):
                out.append(f"  K3_STAMP({i});")
        if line.startswith(WRITE_OUT):
            out.append("  if (threadIdx.x == 0)\n"
                       f"    for (int s_ = 0; s_ < {SECTIONS}; ++s_) "
                       f"k3_split[blockIdx.x * {SECTIONS} + s_] = k3_acc[s_];")
        if line.startswith("namespace {"):
            out.append(f"__device__ long long k3_split[4096 * {SECTIONS}];")
        out.append(line)
        if line.startswith(DECLARE):
            out.append(f"  __shared__ long long k3_acc[{SECTIONS}];\n"
                       "  long long k3_last = clock64();\n"
                       "  if (threadIdx.x == 0)\n"
                       f"    for (int s_ = 0; s_ < {SECTIONS}; ++s_) k3_acc[s_] = 0;")
    body = "\n".join(out) + "\n"
    macro = ("#define K3_STAMP(i) if (threadIdx.x == 0) { const long long t_ = clock64(); "
             "k3_acc[i] += t_ - k3_last; k3_last = t_; }\n")
    reader = ('extern "C" int k3_split_read(long long* out, int n) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, k3_split, sizeof(long long) * n);\n}\n")
    body = body.replace("#include <cuda_runtime.h>", "#include <cuda_runtime.h>\n" + macro, 1)
    return body + reader, names


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_step_split: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    from mpc_for_av_at_intersection_tpu_torch.ops import _build
    from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch

    src, names = instrument((_build.CSRC_DIR / "astar.cu").read_text())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / "astar_split.cu", _build.BUILD_DIR / "libastar_split.so"
    cu.write_text(src)
    build = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS["astar.cu"],
                            "-shared", str(cu), "-o", str(so)], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    ptxas = [ln.strip() for ln in (build.stdout + build.stderr).splitlines() if "registers" in ln]
    split_lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _build._SIGNATURES.items():
        if name.startswith("k3_") and hasattr(split_lib, name):
            getattr(split_lib, name).argtypes, getattr(split_lib, name).restype = argtypes, restype
    split_lib.k3_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

    dev = torch.device("cuda", 0)
    _, cfg, args, _ = chip_smoke.k3_geom_inputs(dev)

    def run():
        return astar_search_batch(*args, max_expansions=chip_smoke.K3_GEOM_EXP)

    own_ms = chip_smoke.cuda_ms(run, 3)
    load = _build.load
    _build.load = lambda: split_lib
    try:
        res = run()
        torch.cuda.synchronize()
        split_ms = chip_smoke.cuda_ms(run, 3)
    finally:
        _build.load = load
    B = args[2].shape[0]
    acc = np.zeros(B * SECTIONS, np.int64)
    err = split_lib.k3_split_read(acc.ctypes.data, acc.size)
    if err:
        print(f"k3_step_split: reading the stamps failed ({err})", file=sys.stderr)
        return 1
    acc = acc.reshape(B, SECTIONS)
    n_exp = res.n_expansions.cpu().numpy()
    row = int(n_exp.argmax())
    steps = int(n_exp[row])
    cycles = acc[row, :len(names)].astype(np.float64)
    step_cycles = cycles[1:].sum() / steps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({
        "card": smi.stdout.strip(), "grid": [cfg.nx, cfg.ny, cfg.ntheta], "row": row,
        "expansions": steps, "kernel_ms": own_ms, "stamped_kernel_ms": split_ms,
        "us_per_expansion": own_ms * 1e3 / steps, "cycles_per_expansion": step_cycles,
        "sections": {name: {"cycles_per_expansion": c / steps, "share": c / steps / step_cycles}
                     for name, c in zip(names[1:], cycles[1:])},
        "setup_cycles": cycles[0], "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
