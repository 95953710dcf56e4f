"""PyTorch port: the cluster layouts of K2, A/B-1 and A/B-2, counted on the CPU.

Past the 232,448 B of shared memory one CTA can have on an H100, K2, A/B-1
and A/B-2 run a scenario on a thread-block cluster of C = 2-4 CTAs whose
shared memory holds its working set. K2's and A/B-1's ADMM phase is split
by rows over the ranks (``csrc/admm.cu::carve_split``: each rank the same
layout, its rows of P, G, G', G'G and M^-1, the whole M, which also stages
another rank's rows of G' for G'G, the vectors and the exchange slots);
the polish (A/B-2, and K2's after its ADMM phase, laid over the same
memory) is split by rows too (``carve_polish``: each rank the same layout,
P and G on its rows, P's factor whole, the vectors, idx, the exchange
slots, and the rest of the rank as the arena of an attempt's active rows).
The wrappers pick C from their own count (``ops.admm.cluster_size``,
``rank_bytes``, ``polish_layout``). Here the source's layouts are compiled
with g++ (cut out of ``csrc/admm.cu``, as ``tests/test_torch_admm_smem.py``
does for ``carve``) over a host buffer of four ranks, and for T = 1..70,
canonical (n = 2T) and jerk (n = 2T + 1), m = 4T - 1, and at problems wider
than the controller's (``WIDE``), for each of the three kernels and every
C = 1..4:

- each rank holds at most 232,448 B; in both layouts every array lies
  inside the rank's floats at the same offsets on every rank, no two
  overlap, the ranks' rows cover each row once; in the split layout M holds
  another rank's rows of G' and an exchange slot the residual check's six
  maxima, and in the polish layout the arena holds an attempt's active
  rows spread over the ranks at a = m (its rows of Vt_a and S_aa), at any
  n and m;
- the source's cluster size and each CTA's bytes equal the Python count:
  C = 1 up to the single-CTA limit (K2 31, A/B-1 37, A/B-2 35), then the
  smallest cluster whose layouts fit;
- the largest T each kernel serves: K2 63 (jerk 63), A/B-1 68 (68), A/B-2
  63 (63); past it no cluster of four holds the working set.
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
# PolishWork's arrays in the order the program prints them (the arena last)
POLISH_ARRAYS = ("P", "G", "M", "q", "x", "xp1", "xp2", "u", "pir", "dx", "r1", "gv", "px", "pxo",
                 "ydiag", "lo", "hi", "y", "Gx", "yp1", "yp2", "dm", "bv", "w", "dl", "w2", "lam",
                 "r2", "idx", "xchg", "red", "arena")
# SplitWork's arrays in the order the program prints them
SPLIT_ARRAYS = ("P", "G", "GT", "GtG", "M", "Mi", "q", "d", "qs", "x", "xt", "rhs", "tn", "ydiag",
                "lo", "hi", "e", "los", "his", "z", "y", "t", "xchg", "red")
ROWS = [(T, jerk) for T in range(1, 71) for jerk in (False, True)]
# (n, m) wider than the controller's that the wrappers run on a cluster
# (tests/test_torch_admm_cluster_split.py): m up to 30 n, and n = 2
WIDE = [(40, 240), (40, 600), (40, 1000), (40, 1200), (2, 5000)]
# the largest horizon each kernel serves, canonical and jerk
LARGEST_T = {K2: (63, 63), AB1: (68, 68), AB2: (63, 63)}
SINGLE_CTA_T = {K2: 31, AB1: 37, AB2: 35}
CAP = SMEM_LIMIT // 4


def _polish_sizes(n, m, C):
    """Each array's floats, as carve_polish takes them (the arena: the rest
    of the rank)."""
    ldn = n | 1
    out = dict(P=-(-n // C) * ldn, G=-(-m // C) * ldn, M=n * ldn, idx=m, xchg=2 * MAX_CLUSTER,
               red=8 * 4)
    out.update({name: n for name in POLISH_ARRAYS[3:15]})
    out.update({name: m for name in POLISH_ARRAYS[15:28]})
    return out


def whole_active_rows(n, m, C):
    """The most active rows a polish attempt keeps whole on every rank on C
    CTAs at (n, m): G_a and Vt_a (a x (n | 1) each) and S_aa (a x (a | 1))
    in the arena that ``polish_layout`` leaves (``csrc/admm.cu::whole_floats``);
    past it they are spread over the ranks."""
    fixed = admm.polish_layout(n, m, C)
    if fixed is None:
        return 0
    arena, ldn = CAP - fixed, n | 1
    return max((a for a in range(m + 1) if 2 * a * ldn + a * (a | 1) <= arena), default=0)


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
    """From the source's layouts compiled for the host: {("polish", n, m,
    C): (fits, floats before the arena, arena floats, [(n0, n1, m0, m1) per
    rank], {array: offset floats})} of the polish layout, {("split", n, m,
    C): (floats, [(n0, n1, m0, m1) per rank], {array: offset floats})} of the
    split layout (the offsets of the last rank laid out; every rank's are
    checked equal in the program), {(kernel, n, m, C): cluster_rank_floats}
    under "floats", and {(kernel, n, m): cluster_size}."""
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
        for C in range(2, MAX_CLUSTER + 1):
            prints.append(f"  split({n}, {m}, {C});")
            prints.append(f"  polish({n}, {m}, {C});")
    fields = ", ".join(f"(float*)s.{a}" for a in POLISH_ARRAYS)
    split_fields = ", ".join(f"s.{a}" for a in SPLIT_ARRAYS)
    prog = "\n".join([
        "#include <cstdio>", "#include <cstddef>", "#include <vector>",
        "#define __host__", "#define __device__", consts,
        cut("struct Work {", "int cluster_size("),
        "static std::vector<float> buf((size_t)MAX_RANKS * (RANK_BYTES / sizeof(float)));",
        "void polish(int n, int m, int C) {",
        "  PolishWork s{}; size_t fixed = 0; long first[64]; int same = 1, k = 0;",
        "  printf(\"polish %d %d %d %d\", n, m, C, polish_fits(n, m, C) ? 1 : 0);",
        "  for (int r = C - 1; r >= 0; --r) {",
        "    fixed = carve_polish(s, buf.data(), n, m, C, r);",
        "    printf(\" %d %d %d %d\", s.n0, s.n1, s.m0, s.m1);",
        f"    float* f[] = {{{fields}}};",
        "    k = 0;",
        "    for (float* p : f) { const long o = (long)(p - buf.data());",
        "      if (r == C - 1) first[k] = o; else same &= first[k] == o; ++k; }",
        "  }",
        "  printf(\" %zu %zu %d\", fixed, s.arena_len, same);",
        "  for (int j = 0; j < k; ++j) printf(\" %ld\", first[j]);",
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
            n, m, C, fits, *rest = vals
            ranks = [tuple(rest[4 * k:4 * k + 4]) for k in range(C)][::-1]
            fixed, arena, same, *offs = rest[4 * C:]
            assert same == 1, ("polish offsets differ between ranks", n, m, C)
            out[("polish", n, m, C)] = (bool(fits), fixed, arena, ranks,
                                        dict(zip(POLISH_ARRAYS, offs)))
    return out


def test_the_sources_constants_are_the_ports(source_layouts):
    assert source_layouts["consts"] == (MAX_CLUSTER, SMEM_LIMIT)
    assert _build.SMEM_LIMIT == SMEM_LIMIT == 232448


def _check_polish(source_layouts, kernel, n, m, C):
    """The polish layout (K2's and A/B-2's) at (n, m) on C ranks: every
    array inside the rank's floats at the same offsets on every rank (the
    program holds them equal), none overlapping, the floats before the
    arena the Python count's, the ranks' rows covering the n and the m rows
    once, in order; where it fits, the arena holds an attempt's active rows
    spread over the ranks at a = m and the whole-rows bound the Python
    count's. Returns whether it fits."""
    fits, fixed, arena, ranks, offs = source_layouts[("polish", n, m, C)]
    sizes = _polish_sizes(n, m, C)
    spans = sorted((off, off + sizes.get(name, 0), name) for name, off in offs.items())
    assert spans[0][0] == 0 and spans[-1] == (fixed, fixed, "arena"), (n, m, C)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), (n, m, C)
    assert arena == max(CAP - fixed, 0), (n, m, C)
    assert ranks[0][0] == 0 and ranks[-1][1] == n and ranks[0][2] == 0 and ranks[-1][3] == m
    assert all(a[1] == b[0] and a[3] == b[2] for a, b in zip(ranks, ranks[1:])), (n, m, C)
    assert fits == (admm.polish_layout(n, m, C) is not None), (n, m, C)
    if not fits:
        return False
    assert fixed == admm.polish_layout(n, m, C), (n, m, C)
    # spread at a = m: ceil(m / C) rows of Vt_a (n | 1) and of S_aa (m | 1)
    assert -(-m // C) * ((n | 1) + (m | 1)) <= arena, (n, m, C)
    whole = whole_active_rows(n, m, C)
    assert 2 * whole * (n | 1) + whole * (whole | 1) <= arena, (n, m, C)
    assert whole == m or 2 * (whole + 1) * (n | 1) + (whole + 1) * ((whole + 1) | 1) > arena
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
    A/B-2 on two CTAs), T=48 (all three on two) and K2's largest, T=63
    (four CTAs); the polish takes the whole rank, its arena what its
    layout leaves (at T=40 on two ranks, an attempt's active rows whole up
    to a = 131)."""
    want = {(K2, 40, False): (2, SMEM_LIMIT), (K2, 40, True): (2, SMEM_LIMIT),
            (AB1, 40, False): (2, 126496), (AB2, 40, False): (2, SMEM_LIMIT),
            (K2, 48, False): (2, SMEM_LIMIT), (AB1, 48, False): (2, 179424),
            (AB2, 48, False): (2, SMEM_LIMIT), (K2, 60, False): (4, SMEM_LIMIT),
            (K2, 63, False): (4, SMEM_LIMIT)}
    for (kernel, T, jerk), (C, nbytes) in want.items():
        n, m = _dims(T, jerk)
        assert cluster_size(kernel, n, m) == C, (kernel, T, jerk)
        assert rank_bytes(kernel, n, m, C) == nbytes, (kernel, T, jerk)
    assert whole_active_rows(*_dims(40), 2) == 131
    # T=64: P's factor and the rows' blocks leave no cluster of four room
    # for the active rows spread at a = m
    n, m = _dims(64)
    assert admm.polish_layout(n, m, MAX_CLUSTER) is None and cluster_size(K2, n, m) == 0
    assert cluster_size(AB2, n, m) == 0 and cluster_size(AB1, n, m) == 4
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
