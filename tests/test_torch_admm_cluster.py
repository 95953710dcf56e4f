"""PyTorch port: the cluster layouts of K2, A/B-1 and A/B-2, counted on the CPU.

Past the 232,448 B of shared memory one CTA can have on an H100, K2, A/B-1
and A/B-2 run a scenario on a thread-block cluster of C = 2-4 CTAs whose
shared memory holds its working set. K2's and A/B-1's ADMM phase is split
by rows over the ranks (``csrc/admm.cu::carve_split``: each rank the same
layout, its rows of P, G, G', G'G and M^-1, the whole M, which also stages
another rank's rows of G' for G'G, the vectors and the exchange slots);
the polish (A/B-2, and K2's after its ADMM phase, laid over the same
memory) runs on rank 0 over ``carve_cluster``'s layout: rank 0 keeps Gs,
the vectors, idx and red; S, M and Y go, each whole, to the first rank
with room from rank 0 on, then P and G, the partners first. The wrappers
pick C from their own count (``ops.admm.cluster_size``, ``rank_bytes``).
Here the source's layouts are compiled with g++ (cut out of
``csrc/admm.cu``, as ``tests/test_torch_admm_smem.py`` does for ``carve``)
over a host buffer of four ranks, and for T = 1..70, canonical (n = 2T)
and jerk (n = 2T + 1), m = 4T - 1, and at problems wider than the
controller's (``WIDE``), for each of the three kernels and every C = 1..4:

- each rank holds at most 232,448 B; in the polish layouts every array lies
  whole in one rank, no two overlap, rank 0 holds the arrays the polish
  reads from its own base and the ranks together hold what ``carve`` lays
  out for A/B-2; in the split layout every array lies inside a rank's
  floats, no two overlap, the ranks' rows cover each row once, M holds
  another rank's rows of G' and an exchange slot the residual check's six
  maxima, at any n and m;
- the source's cluster size and each CTA's bytes equal the Python count:
  C = 1 up to the single-CTA limit (K2 31, A/B-1 37, A/B-2 35), then the
  smallest cluster whose layouts fit;
- the largest T each kernel serves: K2 60 (jerk 60), A/B-1 68 (68), A/B-2
  60 (60); past it no cluster of four holds the working set (K2 and A/B-2
  at T=61: S alone, 243 x 243 floats, passes one CTA).
"""

import re
import shutil
import subprocess

import pytest

from mpc_for_av_at_intersection_tpu_torch.ops import _build, admm
from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
    AB1,
    AB2,
    K2,
    MAX_CLUSTER,
    SMEM_LIMIT,
    cluster_size,
    rank_bytes,
    smem_bytes,
)

from test_torch_admm_smem import SOURCE, _dims

KERNELS = {K2: "kBoth", AB1: "kAdmm", AB2: "kPolish"}
# Work's arrays in the order the program prints them: matrices, then vectors
MATRICES = ("P", "G", "Ps", "Gs", "GtG", "M", "Y", "Mi", "S")
N_VECTORS = ("q", "d", "qs", "x", "xt", "rhs", "tn", "xp1", "xp2", "u", "pir", "dx", "r1", "gv")
M_VECTORS = ("lo", "hi", "e", "los", "his", "z", "y", "t", "Gx", "yp1", "yp2", "dm", "bv", "w",
             "dl", "w2", "lam", "r2")
ARRAYS = MATRICES + N_VECTORS + M_VECTORS + ("idx", "red")
# SplitWork's arrays in the order the program prints them
SPLIT_ARRAYS = ("P", "G", "GT", "GtG", "M", "Mi", "q", "d", "qs", "x", "xt", "rhs", "tn", "ydiag",
                "lo", "hi", "e", "los", "his", "z", "y", "t", "xchg", "red")
ROWS = [(T, jerk) for T in range(1, 71) for jerk in (False, True)]
# (n, m) wider than the controller's that the wrappers run on a cluster
# (tests/test_torch_admm_cluster_split.py): m up to 30 n, and n = 2
WIDE = [(40, 240), (40, 600), (40, 1000), (40, 1200), (2, 5000)]
# the largest horizon each kernel serves, canonical and jerk
LARGEST_T = {K2: (60, 60), AB1: (68, 68), AB2: (60, 60)}
SINGLE_CTA_T = {K2: 31, AB1: 37, AB2: 35}
CAP = SMEM_LIMIT // 4
# the arrays the polish reads from rank 0's own base
OWN = set(ARRAYS) - {"P", "G", "Ps", "GtG", "M", "Y", "S"}


def _sizes(n, m):
    """Each array's floats, as carve and carve_cluster take them."""
    ldn, ldm = n | 1, m | 1
    out = {name: n * ldn for name in MATRICES}
    out.update(G=m * ldn, Gs=m * ldn, S=m * ldm, idx=m, red=8 * 4)
    out.update({name: n for name in N_VECTORS})
    out.update({name: m for name in M_VECTORS})
    return out


def _split_sizes(n, m, C):
    """Each array's floats, as carve_split takes them."""
    ldn, ldt = n | 1, m | 1
    pn, pm = -(-n // C), -(-m // C)
    out = dict(P=pn * ldn, G=pm * ldn, GT=pn * ldt, GtG=pn * ldn, M=max(n * ldn, pn * ldt),
               Mi=pn * ldn, xchg=2 * C * max(2 * n, 6), red=8 * 4)
    out.update({name: n for name in SPLIT_ARRAYS[6:14]})
    out.update({name: m for name in SPLIT_ARRAYS[14:22]})
    return out


@pytest.fixture(scope="module")
def source_layouts(tmp_path_factory):
    """From the source's layouts compiled for the host, with rank r's window
    at floats r * CAP of one buffer: {(kernel, n, m, C): (fits, used floats
    per rank, {array: offset floats from the buffer or -1 where null})} of
    the polish layout, {("split", n, m, C): (floats, [(n0, n1, m0, m1) per rank],
    {array: offset floats})} of the split layout, {(kernel, n, m, C):
    cluster_rank_floats} under "floats", and {(kernel, n, m): cluster_size}."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the source's layout")
    src = SOURCE.read_text()

    def cut(start, end):
        a = src.index(start)
        b = src.index("\n}\n", src.index(end, a)) + 3
        return src[a:b]

    consts = "\n".join(re.search(rf"constexpr int {name} = [^;]+;", src).group(0)
                       for name in ("K2_THREADS", "NWARPS", "MAX_RED"))
    prints = []
    for n, m in [_dims(T, jerk) for T, jerk in ROWS] + WIDE:
        for kernel, phases in KERNELS.items():
            prints.append(f"  printf(\"size {kernel} {n} {m} %d\\n\", cluster_size({n}, {m}, "
                          f"{phases}));")
            for C in range(1, MAX_CLUSTER + 1):
                prints.append(f"  printf(\"floats {kernel} {n} {m} {C} %zu\\n\", "
                              f"cluster_rank_floats({n}, {m}, {phases}, {C}));")
                if kernel != AB1:
                    prints.append(f"  show({kernel}, {n}, {m}, {C});")
        for C in range(2, MAX_CLUSTER + 1):
            prints.append(f"  split({n}, {m}, {C});")
    fields = ", ".join(f"(float*)s.{a}" for a in ARRAYS)
    split_fields = ", ".join(f"s.{a}" for a in SPLIT_ARRAYS)
    prog = "\n".join([
        "#include <cstdio>", "#include <cstddef>", "#include <vector>",
        "#define __host__", "#define __device__", consts,
        cut("struct Work {", "int cluster_size("),
        "static std::vector<float> buf((size_t)MAX_RANKS * (RANK_BYTES / sizeof(float)));",
        "struct HostRanks {",
        "  float* operator()(int r, size_t off) const {",
        "    return buf.data() + (size_t)r * (RANK_BYTES / sizeof(float)) + off; }",
        "};",
        "void show(int kernel, int n, int m, int C) {",
        "  Work s{}; size_t used[MAX_RANKS];",
        "  const bool fits = carve_cluster(s, buf.data(), HostRanks{}, n, m, C, used);",
        "  printf(\"layout %d %d %d %d %d\", kernel, n, m, C, fits ? 1 : 0);",
        "  for (int r = 0; r < MAX_RANKS; ++r) printf(\" %zu\", used[r]);",
        f"  float* f[] = {{{fields}}};",
        "  for (float* p : f) printf(\" %ld\", p ? (long)(p - buf.data()) : -1L);",
        "  printf(\"\\n\");",
        "}",
        "void split(int n, int m, int C) {",
        "  SplitWork s{};",
        "  printf(\"split %d %d %d\", n, m, C);",
        "  for (int r = C - 1; r >= 0; --r) {",
        "    const size_t floats = carve_split(s, buf.data(), n, m, C, r);",
        "    if (r == C - 1) printf(\" %zu\", floats);",
        "    printf(\" %d %d %d %d\", s.n0, s.n1, s.m0, s.m1);",
        "  }",
        f"  float* f[] = {{{split_fields}}};",
        "  for (float* p : f) printf(\" %ld\", (long)(p - buf.data()));",
        "  printf(\"\\n\");",
        "}",
        f'int main() {{ printf("%d %zu\\n", MAX_RANKS, RANK_BYTES);',
        *prints, "}"])
    tmp = tmp_path_factory.mktemp("cluster")
    cpp, exe = tmp / "cluster.cpp", tmp / "cluster"
    cpp.write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O1", str(cpp), "-o", str(exe)], check=True,
                   capture_output=True, timeout=300)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    out = {"consts": tuple(int(v) for v in lines[0].split()), "floats": {}}
    for line in lines[1:]:
        head, *vals = line.split()
        vals = list(map(int, vals))
        if head == "size":
            kernel, n, m, c = vals
            out[(kernel, n, m)] = c
        elif head == "floats":
            kernel, n, m, C, floats = vals
            out["floats"][(kernel, n, m, C)] = floats
        elif head == "split":
            n, m, C, floats, *rest = vals
            ranks = [tuple(rest[4 * k:4 * k + 4]) for k in range(C)][::-1]
            out[("split", n, m, C)] = (floats, ranks, dict(zip(SPLIT_ARRAYS, rest[4 * C:])))
        else:
            kernel, n, m, C, fits, *rest = vals
            used = rest[:MAX_CLUSTER]
            out[(kernel, n, m, C)] = (bool(fits), used, dict(zip(ARRAYS, rest[MAX_CLUSTER:])))
    return out


def test_the_sources_constants_are_the_ports(source_layouts):
    assert source_layouts["consts"] == (MAX_CLUSTER, SMEM_LIMIT)
    assert _build.SMEM_LIMIT == SMEM_LIMIT == 232448


def _check_polish(source_layouts, kernel, n, m, C):
    """The polish layout (K2's or A/B-2's) at (n, m) on C ranks, where it
    fits: each rank within CAP, each array whole in one rank, none
    overlapping, rank 0's own arrays on rank 0 (and S, M and Y on rank 0
    where it has room for them after its own), the ranks adding up to
    A/B-2's working set on one CTA. Returns whether it fits."""
    fits, used, offs = source_layouts[(kernel, n, m, C)]
    if not fits:
        return False
    sizes = _sizes(n, m)
    assert all(u <= CAP for u in used) and not any(used[C:]), (kernel, n, m, C)
    spans = {r: [] for r in range(C)}
    for name, off in offs.items():
        if off < 0:
            continue
        rank, start = divmod(off, CAP)
        assert rank < C and start + sizes[name] <= used[rank], (kernel, n, m, C, name)
        spans[rank].append((start, start + sizes[name], name))
        if name in OWN:
            assert rank == 0, (kernel, n, m, C, name)
    own = sum(sizes[a] for a in OWN if offs[a] >= 0)
    if own + sizes["S"] + 2 * sizes["M"] <= CAP:
        assert all(offs[a] // CAP == 0 for a in ("S", "M", "Y")), (n, m, C)
    for rank, s in spans.items():
        s.sort()
        assert all(a[1] <= b[0] for a, b in zip(s, s[1:])), (kernel, n, m, C, rank)
        assert sum(b - a for a, b, _ in s) == used[rank], (kernel, n, m, C, rank)
    assert 4 * sum(used) == smem_bytes(AB2, n, m), (kernel, n, m, C)
    return True


def _check_split(source_layouts, n, m, C):
    """The split layout at (n, m) on C ranks: every array inside the rank's
    floats, none overlapping, the floats the Python count's, the ranks'
    rows covering the n and the m rows once, in order. Returns whether it
    fits a rank."""
    floats, ranks, offs = source_layouts[("split", n, m, C)]
    sizes = _split_sizes(n, m, C)
    # what the kernels put there: another rank's rows of G' (gram_split),
    # the six maxima of the residual check (admm_residuals_split)
    assert sizes["M"] >= -(-n // C) * (m | 1) and sizes["xchg"] >= 2 * C * 6, (n, m, C)
    spans = sorted((off, off + sizes[name], name) for name, off in offs.items())
    assert spans[0][0] == 0 and spans[-1][1] == floats, (n, m, C)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), (n, m, C)
    assert floats == admm.split_floats(n, m, C), (n, m, C)
    assert ranks[0][0] == 0 and ranks[-1][1] == n and ranks[0][2] == 0 and ranks[-1][3] == m
    assert all(a[1] == b[0] and a[3] == b[2] for a, b in zip(ranks, ranks[1:])), (n, m, C)
    return floats <= CAP


@pytest.mark.parametrize("kernel", [K2, AB1, AB2])
def test_every_rank_fits_and_every_array_lies_whole_in_one(source_layouts, kernel):
    """K2 and A/B-2 in their polish layouts, K2 and A/B-1 in the split
    layout (``_check_polish``, ``_check_split``), at every shape and C."""
    checked = 0
    for T, jerk in ROWS:
        n, m = _dims(T, jerk)
        for C in range(2, MAX_CLUSTER + 1):
            fit_polish = kernel == AB1 or _check_polish(source_layouts, kernel, n, m, C)
            fit_split = kernel == AB2 or _check_split(source_layouts, n, m, C)
            checked += fit_polish and fit_split
    assert checked >= 2 * len(ROWS)


@pytest.mark.parametrize("kernel", [K2, AB1, AB2])
def test_the_python_count_equals_the_sources(source_layouts, kernel):
    for T, jerk in ROWS:
        n, m = _dims(T, jerk)
        C = source_layouts[(kernel, n, m)]
        assert cluster_size(kernel, n, m) == C, (kernel, T, jerk)
        for c in range(2, MAX_CLUSTER + 1):
            assert rank_bytes(kernel, n, m, c) == 4 * source_layouts["floats"][(kernel, n, m, c)], (
                kernel, T, c)
        if C == 1:
            assert smem_bytes(kernel, n, m) <= SMEM_LIMIT
        elif C > 1:
            assert smem_bytes(kernel, n, m) > SMEM_LIMIT
            assert C == 2 or source_layouts["floats"][(kernel, n, m, C - 1)] == 0, (kernel, T)
            assert 0 < rank_bytes(kernel, n, m, C) <= SMEM_LIMIT


@pytest.mark.parametrize("kernel", [K2, AB1, AB2])
def test_one_cta_up_to_its_limit_then_the_smallest_cluster(source_layouts, kernel):
    for jerk in (False, True):
        sizes = [source_layouts[(kernel, *_dims(T, jerk))] for T in range(1, 71)]
        single = SINGLE_CTA_T[kernel]
        if not jerk:
            assert sizes[single - 1] == 1 and sizes[single] == 2, kernel
        assert sizes == sorted(sizes[:sizes.index(0)]) + [0] * (70 - sizes.index(0)), kernel
        assert sizes.index(0) == LARGEST_T[kernel][int(jerk)], (kernel, jerk)


def test_the_sizes_the_slice_runs():
    """The horizons the card runs past one CTA: T=40 (K2, jerk, A/B-1,
    A/B-2 on two CTAs), T=48 (K2 and A/B-2 on three, A/B-1 on two) and K2's
    largest, T=60 (three CTAs)."""
    want = {(K2, 40, False): (2, 216392), (K2, 40, True): (2, 217076),
            (AB1, 40, False): (2, 126496), (AB2, 40, False): (2, 216392),
            (K2, 48, False): (3, 183172), (AB1, 48, False): (2, 179424),
            (AB2, 48, False): (3, 183172), (K2, 60, False): (3, 231836)}
    for (kernel, T, jerk), (C, nbytes) in want.items():
        n, m = _dims(T, jerk)
        assert cluster_size(kernel, n, m) == C, (kernel, T, jerk)
        assert rank_bytes(kernel, n, m, C) == nbytes, (kernel, T, jerk)
    # T=61: the polish's S alone passes one CTA
    n, m = _dims(61)
    assert 4 * m * (m | 1) > SMEM_LIMIT and cluster_size(K2, n, m) == 0
    assert cluster_size(AB2, n, m) == 0 and cluster_size(AB1, n, m) == 3
    assert admm.check_smem("K2", K2, *_dims(40)) == 2


@pytest.mark.parametrize("n,m", WIDE)
def test_wider_problems_than_the_controllers_fit_the_split_layout(source_layouts, n, m):
    """At m up to 30 n, and at n = 2, the source's layouts hold (``_check_split``:
    M as large as another rank's rows of G', which G'G stages there; an
    exchange slot as large as the residual check's six maxima;
    ``_check_polish`` where the polish layout fits), and the source's
    cluster size and bytes equal the Python count."""
    for kernel in (K2, AB1, AB2):
        C = source_layouts[(kernel, n, m)]
        assert cluster_size(kernel, n, m) == C, (kernel, n, m)
        for c in range(2, MAX_CLUSTER + 1):
            assert rank_bytes(kernel, n, m, c) == 4 * source_layouts["floats"][(kernel, n, m, c)]
            if kernel != AB1:
                _check_polish(source_layouts, kernel, n, m, c)
    for c in range(2, MAX_CLUSTER + 1):
        _check_split(source_layouts, n, m, c)
    assert max(source_layouts[(k, n, m)] for k in (K2, AB1)) > 1
