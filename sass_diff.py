#!/usr/bin/env python3
"""Compare the SASS of the CUDA kernels that two checkouts of the port build.

Builds the kernel library of this checkout's
``mpc_for_av_at_intersection_tpu_torch`` and of the one under ``OTHER`` (each
in a subprocess of its own, into its own ``_build/``), disassembles both with
``cuobjdump -sass`` and compares every ``__global__`` function the two have
in common instruction for instruction: names with the anonymous namespace's
per-build tag removed, each instruction's text without its address or
encoding. Prints one JSON line: the functions equal, those that differ
(with their instruction counts) and those only one library has.

    python3 sass_diff.py _checkout/parent

Needs the CUDA toolkit (nvcc, cuobjdump), so it runs on the machine with
the card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from mpc_for_av_at_intersection_tpu_torch.ops import _build; print(_build.build())")


def library(root: Path) -> Path:
    out = subprocess.run([sys.executable, "-c", _BUILD, str(root)], capture_output=True,
                         text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path) -> dict:
    """{normalized function name: [instruction text]} of ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON", hit[1])
            out[name] = []
        elif name and (ins := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)):
            out[name].append(ins[1].strip())
    return out


def main() -> int:
    here = Path(__file__).resolve().parent
    mine, other = functions(library(here)), functions(library(Path(sys.argv[1]).resolve()))
    common = sorted(set(mine) & set(other))
    print(json.dumps({
        "equal": [f for f in common if mine[f] == other[f]],
        "differ": {f: [len(mine[f]), len(other[f])] for f in common if mine[f] != other[f]},
        "only_here": sorted(set(mine) - set(other)),
        "only_there": sorted(set(other) - set(mine))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
