"""PyTorch port: the ADMM kernels' shared memory, and the wrappers' refusal of a
problem that does not fit.

One CTA of K2, A/B-1, A/B-2 or a probe holds one scenario's whole working
set in dynamic shared memory, laid out by ``csrc/admm.cu::carve`` (K2,
A/B-1, A/B-2) and ``carve_probe`` (Probe-3; Probe-1 and -2), up to the
232,448 B one CTA can have on an H100. Past it K2, A/B-1 and A/B-2 run a
scenario on a cluster of 2-4 CTAs (``tests/test_torch_admm_cluster.py``
holds that layout); the probes stay on one CTA. The wrappers count the
working set in Python (``ops.admm.smem_bytes``) and refuse, before any
build or launch, a problem that no cluster (probes: no CTA) holds:

- the count equals the source's own ``smem_bytes``/``probe_smem_bytes``,
  compiled from ``csrc/admm.cu`` on the host with g++, for T = 1..70 at
  the canonical n = 2T and the jerk variant's n = 2T + 1 (m = 4T - 1);
- the sizes at the shipped horizons T=13 and T=20, and the largest T
  one CTA holds: K2 31 (jerk 31), A/B-1 37, A/B-2 35, Probe-3 68,
  Probe-1/2 44, where K2, A/B-1 and A/B-2 go from one CTA to a cluster of
  two;
- the largest T each wrapper serves: K2 63, A/B-1 68, A/B-2 63 (on a
  cluster), Probe-3 68, Probe-1/2 44; one horizon past it each wrapper
  raises ``ValueError`` naming the horizon and the bytes, and counts no
  launch. ``meta`` tensors stand in for CUDA ones here
  (``tests/test_torch_port_imports.py`` does the same);
  ``tests/test_torch_kernels_cuda.py`` repeats the refusal on the card and
  holds the count to the built library's.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mpc_for_av_at_intersection_tpu_torch.mpc.qp import QPSolution
from mpc_for_av_at_intersection_tpu_torch.ops import admm
from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
    AB1,
    AB2,
    K2,
    PROBE3,
    PROBE12,
    SMEM_LIMIT,
    cluster_size,
    polish_select,
    ruiz_admm_all_rounds,
    smem_bytes,
    solve_box_qp_fused,
)
from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
    admm_all_rounds,
    admm_iterations,
    admm_round_full,
)

SOURCE = Path(admm.__file__).resolve().parent.parent / "csrc" / "admm.cu"
# the largest horizon one CTA holds, and the largest each wrapper serves
SINGLE_CTA_T = {K2: 31, AB1: 37, AB2: 35, PROBE3: 68, PROBE12: 44}
LARGEST_T = {K2: 63, AB1: 68, AB2: 63, PROBE3: 68, PROBE12: 44}


def _dims(T, jerk=False):
    return 2 * T + int(jerk), 4 * T - 1


def _host_counts(tmp_path):
    """The source's smem_bytes/probe_smem_bytes compiled for the host: the
    Work and ProbeWork layouts, the Phases, carve, carve_probe and the
    constants they read, cut out of csrc/admm.cu. Returns {(kernel, n, m):
    bytes}."""
    src = SOURCE.read_text()

    def cut(start, end):
        a = src.index(start)
        b = src.index("\n}\n", src.index(end, a)) + 3
        return src[a:b]

    consts = "\n".join(re.search(rf"constexpr int {name} = [^;]+;", src).group(0)
                       for name in ("K2_THREADS", "NWARPS", "MAX_RED"))
    rows = [(T, jerk) for T in range(1, 71) for jerk in (False, True)]
    prog = "\n".join([
        "#include <cstdio>", "#include <cstddef>", "#define __host__", "#define __device__",
        consts, cut("struct Work {", "size_t smem_bytes("),
        cut("struct ProbeWork {", "size_t probe_smem_bytes("),
        "int main() {",
        *(f'  printf("%zu %zu %zu %zu %zu\\n", smem_bytes({n}, {m}, kBoth), '
          f'smem_bytes({n}, {m}, kAdmm), smem_bytes({n}, {m}, kPolish), '
          f'probe_smem_bytes({n}, {m}, false), probe_smem_bytes({n}, {m}, true));'
          for n, m in (_dims(T, jerk) for T, jerk in rows)),
        "}"])
    cpp, exe = tmp_path / "carve.cpp", tmp_path / "carve"
    cpp.write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O0", str(cpp), "-o", str(exe)], check=True,
                   capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.split("\n")
    counts = {}
    for (T, jerk), line in zip(rows, out):
        n, m = _dims(T, jerk)
        for kernel, value in zip((K2, AB1, AB2, PROBE3, PROBE12), line.split()):
            counts[(kernel, n, m)] = int(value)
    return counts


def test_count_equals_the_sources_carve(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the source's count")
    counts = _host_counts(tmp_path)
    assert len(counts) == 5 * 140
    for (kernel, n, m), nbytes in counts.items():
        assert smem_bytes(kernel, n, m) == nbytes, (kernel, n, m)


def test_sizes_at_the_shipped_horizons_and_the_largest_that_fits():
    assert SMEM_LIMIT == 232448
    want = {13: {K2: 43728, AB1: 30352, AB2: 33764, PROBE3: 9880, PROBE12: 21112},
            20: {K2: 98608, AB1: 69048, AB2: 76548, PROBE3: 21864, PROBE12: 48104}}
    for T, sizes in want.items():
        for kernel, nbytes in sizes.items():
            assert smem_bytes(kernel, *_dims(T)) == nbytes, (T, kernel)
    assert smem_bytes(K2, *_dims(20, jerk=True)) == 99648
    for kernel, T in SINGLE_CTA_T.items():
        assert smem_bytes(kernel, *_dims(T)) <= SMEM_LIMIT < smem_bytes(kernel, *_dims(T + 1))
        assert cluster_size(kernel, *_dims(T)) == 1
        assert cluster_size(kernel, *_dims(T + 1)) == (2 if kernel in (K2, AB1, AB2) else 0)
    assert smem_bytes(K2, *_dims(31, True)) <= SMEM_LIMIT < smem_bytes(K2, *_dims(32, True))
    for kernel, T in LARGEST_T.items():
        assert cluster_size(kernel, *_dims(T)) > 0 and cluster_size(kernel, *_dims(T + 1)) == 0


def _meta_problem(T):
    n, m = _dims(T)
    meta = dict(device="meta")
    return (torch.empty(2, n, n, **meta), torch.empty(2, n, **meta), torch.empty(2, m, n, **meta),
            torch.empty(2, m, **meta), torch.empty(2, m, **meta))


def _launches():
    return tuple(f.launches for f in (solve_box_qp_fused, ruiz_admm_all_rounds, polish_select,
                                      admm_iterations, admm_round_full, admm_all_rounds))


def _call(kernel, T):
    """A call of ``kernel``'s wrapper on a meta problem of horizon T."""
    P, q, G, lo, hi = _meta_problem(T)
    rho = lo[:, 0]
    return {
        K2: lambda: solve_box_qp_fused(P, q, G, lo, hi),
        AB1: lambda: ruiz_admm_all_rounds(P, q, G, lo, hi),
        AB2: lambda: polish_select(P, q, G, lo, hi, QPSolution(q, lo, rho.bool(), rho, rho)),
        PROBE3: lambda: admm_iterations(P, G, q, lo, hi, rho, q, lo, lo, 5, 1e-6, 1.6),
        PROBE12: lambda: admm_round_full(P, G, q, lo, hi, rho, q, lo, lo, 5, 1e-6, 1.6),
        "Probe-2": lambda: admm_all_rounds(P, G, q, lo, hi, rho, q, lo, lo, 2, 5, 1e-6, 1.6),
    }[kernel]


@pytest.mark.parametrize("kernel", [K2, AB1, AB2, PROBE3, PROBE12, "Probe-2"])
def test_wrappers_refuse_one_horizon_past_the_limit(kernel):
    counted = PROBE12 if kernel == "Probe-2" else kernel
    T = LARGEST_T[counted] + 1
    nbytes = smem_bytes(counted, *_dims(T))
    before = _launches()
    with pytest.raises(ValueError, match=rf"\(horizon T={T}\) needs {nbytes} B of shared memory"):
        _call(kernel, T)()
    assert _launches() == before
    # at the largest horizon that fits, the call gets past the count to the
    # tensor checks (meta tensors are no CUDA tensors)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _call(kernel, T - 1)()
    assert _launches() == before


def test_a_problem_that_is_no_horizon_is_named_by_its_dimensions():
    P, q, G = torch.empty(1, 130, 130, device="meta"), torch.empty(1, 130, device="meta"), \
        torch.empty(1, 250, 130, device="meta")
    lo = torch.empty(1, 250, device="meta")
    with pytest.raises(ValueError, match=r"n=130, m=250 needs \d+ B of shared memory that a "
                                         r"cluster of 4 CTAs of 232448 B \(929792 B\) does not hold"):
        solve_box_qp_fused(P, q, G, lo, lo)
