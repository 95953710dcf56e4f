"""PyTorch port: the cluster layout of K2, A/B-1 and A/B-2, counted on the CPU.

Past the 232,448 B of shared memory one CTA can have on an H100, K2, A/B-1
and A/B-2 run a scenario on a thread-block cluster of C = 2-4 CTAs whose
shared memory holds its working set, laid out by
``csrc/admm.cu::carve_cluster``: rank 0 keeps Gs, M^-1, the vectors, idx
and red; P, G, Ps, G'G, M, Y and S go, each whole, to the first rank with
room, the partners before rank 0. The wrappers pick C from their own count
(``ops.admm.cluster_size``, ``rank_bytes``). Here the source's layout is
compiled with g++ (cut out of ``csrc/admm.cu``, as
``tests/test_torch_admm_smem.py`` does for ``carve``) over a host buffer of
four ranks, and for T = 1..70, canonical (n = 2T) and jerk (n = 2T + 1),
m = 4T - 1, for each of the three kernels and every C = 1..4:

- each rank holds at most 232,448 B, every array lies whole in one rank,
  no two overlap, and rank 0 holds the arrays the iteration reads every
  step;
- the ranks together hold what ``carve`` lays out on one CTA;
- the source's cluster size and each CTA's bytes equal the Python count:
  C = 1 up to the single-CTA limit (K2 31, A/B-1 37, A/B-2 35), then the
  smallest cluster that fits;
- the largest T each kernel serves: K2 60 (jerk 59), A/B-1 67 (67), A/B-2
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
ROWS = [(T, jerk) for T in range(1, 71) for jerk in (False, True)]
# the largest horizon each kernel serves, canonical and jerk
LARGEST_T = {K2: (60, 59), AB1: (67, 67), AB2: (60, 60)}
SINGLE_CTA_T = {K2: 31, AB1: 37, AB2: 35}
CAP = SMEM_LIMIT // 4


def _sizes(n, m):
    """Each array's floats, as carve and carve_cluster take them."""
    ldn, ldm = n | 1, m | 1
    out = {name: n * ldn for name in MATRICES}
    out.update(G=m * ldn, Gs=m * ldn, S=m * ldm, idx=m, red=8 * 4)
    out.update({name: n for name in N_VECTORS})
    out.update({name: m for name in M_VECTORS})
    return out


@pytest.fixture(scope="module")
def source_layouts(tmp_path_factory):
    """{(kernel, n, m, C): (fits, used floats per rank, {array: offset
    floats from the buffer or -1 where null}), (kernel, n, m): cluster_size}
    from the source's carve_cluster and cluster_size compiled for the host,
    with rank r's window at floats r * CAP of one buffer."""
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
    for T, jerk in ROWS:
        n, m = _dims(T, jerk)
        for kernel, phases in KERNELS.items():
            prints.append(f"  printf(\"size {kernel} {n} {m} %d\\n\", cluster_size({n}, {m}, "
                          f"{phases}));")
            for C in range(1, MAX_CLUSTER + 1):
                prints.append(f"  show({kernel}, {n}, {m}, {phases}, {C});")
    fields = ", ".join(f"(float*)s.{a}" for a in ARRAYS)
    prog = "\n".join([
        "#include <cstdio>", "#include <cstddef>", "#include <vector>",
        "#define __host__", "#define __device__", consts,
        cut("struct Work {", "int cluster_size("),
        "static std::vector<float> buf((size_t)MAX_RANKS * (RANK_BYTES / sizeof(float)));",
        "struct HostRanks {",
        "  float* operator()(int r, size_t off) const {",
        "    return buf.data() + (size_t)r * (RANK_BYTES / sizeof(float)) + off; }",
        "};",
        "void show(int kernel, int n, int m, int phases, int C) {",
        "  Work s{}; size_t used[MAX_RANKS];",
        "  const bool fits = carve_cluster(s, buf.data(), HostRanks{}, n, m, phases, C, used);",
        "  printf(\"layout %d %d %d %d %d\", kernel, n, m, C, fits ? 1 : 0);",
        "  for (int r = 0; r < MAX_RANKS; ++r) printf(\" %zu\", used[r]);",
        f"  float* f[] = {{{fields}}};",
        "  for (float* p : f) printf(\" %ld\", p ? (long)(p - buf.data()) : -1L);",
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
    out = {"consts": tuple(int(v) for v in lines[0].split())}
    for line in lines[1:]:
        head, *vals = line.split()
        if head == "size":
            kernel, n, m, c = map(int, vals)
            out[(kernel, n, m)] = c
        else:
            kernel, n, m, C, fits, *rest = map(int, vals)
            used = rest[:MAX_CLUSTER]
            out[(kernel, n, m, C)] = (bool(fits), used, dict(zip(ARRAYS, rest[MAX_CLUSTER:])))
    return out


def test_the_sources_constants_are_the_ports(source_layouts):
    assert source_layouts["consts"] == (MAX_CLUSTER, SMEM_LIMIT)
    assert _build.SMEM_LIMIT == SMEM_LIMIT == 232448


@pytest.mark.parametrize("kernel", [K2, AB1, AB2])
def test_every_rank_fits_and_every_array_lies_whole_in_one(source_layouts, kernel):
    checked = 0
    for T, jerk in ROWS:
        n, m = _dims(T, jerk)
        sizes = _sizes(n, m)
        for C in range(1, MAX_CLUSTER + 1):
            fits, used, offs = source_layouts[(kernel, n, m, C)]
            if not fits:
                continue
            checked += 1
            assert all(u <= CAP for u in used) and not any(used[C:]), (kernel, n, m, C)
            spans = {r: [] for r in range(C)}
            for name, off in offs.items():
                if off < 0:
                    continue
                rank, start = divmod(off, CAP)
                assert rank < C and start + sizes[name] <= used[rank], (kernel, n, m, C, name)
                spans[rank].append((start, start + sizes[name], name))
                if name not in ("P", "G", "Ps", "GtG", "M", "Y", "S"):
                    assert rank == 0, (kernel, n, m, C, name)
            for rank, s in spans.items():
                s.sort()
                assert all(a[1] <= b[0] for a, b in zip(s, s[1:])), (kernel, n, m, C, rank)
                assert sum(b - a for a, b, _ in s) == used[rank], (kernel, n, m, C, rank)
            # the ranks together hold carve's working set, array for array
            assert 4 * sum(used) == smem_bytes(kernel, n, m), (kernel, n, m, C)
    assert checked >= 2 * len(ROWS)


@pytest.mark.parametrize("kernel", [K2, AB1, AB2])
def test_the_python_count_equals_the_sources(source_layouts, kernel):
    for T, jerk in ROWS:
        n, m = _dims(T, jerk)
        C = source_layouts[(kernel, n, m)]
        assert cluster_size(kernel, n, m) == C, (kernel, T, jerk)
        for c in range(2, MAX_CLUSTER + 1):
            fits, used, _ = source_layouts[(kernel, n, m, c)]
            assert rank_bytes(kernel, n, m, c) == (4 * max(used) if fits else 0), (kernel, T, c)
        if C == 1:
            assert smem_bytes(kernel, n, m) <= SMEM_LIMIT
        elif C > 1:
            assert smem_bytes(kernel, n, m) > SMEM_LIMIT
            assert not source_layouts[(kernel, n, m, C - 1)][0] or C == 2, (kernel, T, jerk)
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
    A/B-2 on two CTAs) and T=48 (K2 on three)."""
    want = {(K2, 40, False): (2, 195252), (K2, 40, True): (2, 195632),
            (AB1, 40, False): (2, 181116), (AB2, 40, False): (2, 230400),
            (K2, 48, False): (3, 223100), (AB1, 48, False): (2, 223100),
            (AB2, 48, False): (3, 185852), (K2, 60, False): (4, 231836)}
    for (kernel, T, jerk), (C, nbytes) in want.items():
        n, m = _dims(T, jerk)
        assert cluster_size(kernel, n, m) == C, (kernel, T, jerk)
        assert rank_bytes(kernel, n, m, C) == nbytes, (kernel, T, jerk)
    # T=61: the polish's S alone passes one CTA
    n, m = _dims(61)
    assert 4 * m * (m | 1) > SMEM_LIMIT and cluster_size(K2, n, m) == 0
    assert cluster_size(AB2, n, m) == 0 and cluster_size(AB1, n, m) == 4
    assert admm.check_smem("K2", K2, *_dims(40)) == 2
