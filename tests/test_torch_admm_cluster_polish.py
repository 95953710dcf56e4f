"""PyTorch port, K2's polish and A/B-2 on a cluster: the polish split over the
cluster's ranks, compiled from ``csrc/admm.cu`` on the host.

Past one CTA's shared memory the polish (A/B-2, and K2's after its split ADMM
phase) runs on every rank of a cluster of C = 2-4 CTAs over
``carve_polish``'s layout: rank r holds P and G on its rows (``rank_rows``),
P's factor whole (L, then Y = L^-1 in M's upper triangle,
``tri_inverse_upper``), the vectors whole and an arena. The products of P and
G with a vector are formed by the rows' owners, a row on a quad in dot()'s
order (``rows_on_quads``); an attempt's Vt_a by rows of the active rows
(``rank_rows`` of a), each entry a thread; where the arena holds the active
rows whole (``whole_floats``) every rank repeats the rest (S_aa, its
factor, the KKT solves, ``apply_pinv_c`` through Y in M's upper triangle),
else Vt_a's and S_aa's rows sit on their owners (``Spread``).

These tests cut the source's ownership (``rank_rows``), its quad placement
(``tile_row`` .. ``g_rows``), ``dot``, the factor helpers
(``tri_inverse_cols``, ``tri_inverse_upper``, ``apply_pinv``,
``apply_pinv_c``) and the polish layout (``carve_polish``, ``whole_floats``,
``spread_floats``, ``polish_fits``) out of ``csrc/admm.cu``, compile them
with g++ at ``-ffp-contract=off`` and, at every (n, m) the wrappers run the
polish on a cluster (K2 and A/B-2 at T = 32-63, canonical and jerk, where
they take a cluster), at the wider problems the wrappers put there
(``WIDE``) and C = 2, 3, 4 where the layout fits, emulate each rank's 256
threads as the source places them, and hold:

- every output entry of every polish phase owned by exactly one rank and
  one quad or thread: P v and G v on the rows' owners (the objective and
  Gx, the refinement's P xp, the accept test's P xp and G xp, the
  select's G x), Vt_a's entries (a = 0, 1, 7, the most kept whole, m), and
  with the active rows spread S_aa's lower triangle; kept whole, S_aa's
  entries once in every rank's copy;
- each owned sum equal to ``dot()``'s order bit for bit on random float32
  data: the quads' P v and G v against ``dot`` of the whole row, Vt_a's
  entries through Y in M's upper triangle against ``dot`` of Y's rows
  (``tri_inverse_cols``) and the staged row of G, ``apply_pinv_c``
  against ``apply_pinv``;
- the layout: P's and G's row blocks, the factor, the vectors and the arena
  at the same offsets on every rank, within the rank, the floats before
  the arena ``ops/admm.py::polish_layout``'s, the active rows kept whole
  up to ``whole_active_rows`` (G_a, Vt_a and S_aa in the
  arena) and, spread at a = m, a rank's rows of Vt_a and S_aa in it.
"""

import re
import shutil
import subprocess

import pytest

from mpc_for_av_at_intersection_tpu_torch.ops import admm
from mpc_for_av_at_intersection_tpu_torch.ops.admm import AB2, K2, MAX_CLUSTER, cluster_size

from test_torch_admm_cluster import whole_active_rows
from test_torch_admm_smem import SOURCE, _dims
from test_torch_admm_tiles import _cut

CLUSTERS = (2, 3, 4)
# (n, m) the wrappers run the polish on a cluster at the controller's
# horizons, and wider problems they also put there
SERVED = sorted({_dims(T, jerk) for T in range(32, 64) for jerk in (False, True)
                 if max(cluster_size(k, *_dims(T, jerk)) for k in (K2, AB2)) > 1})
WIDE = [(40, 240), (2, 300)]
CASES = [(n, m, C) for n, m in SERVED + WIDE for C in CLUSTERS
         if admm.polish_layout(n, m, C) is not None]

PROGRAM = r"""
#include <cmath>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>
#define __host__
#define __device__
#define __forceinline__ inline
%(consts)s
struct { int x; } threadIdx = {0};
#define __syncthreads()
%(dot)s
%(tiles)s
%(rows)s
%(layout)s
// the single-thread run of the source's factor helpers: one "thread" walks
// every column and entry, so each barrier falls between two whole phases
namespace one {
constexpr int K2_THREADS = 1;
%(work)s
%(inverse)s
%(upper)s
%(pinv)s
%(pinv_c)s
}  // namespace one

bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }

// dot() as nvcc contracts it, s_c = fma(a, b, s_c) (this program's dot() is
// built without contraction: it is held only to itself)
float dot_ref(const float* a, int sa, const float* b, int sb, int len) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < len; k += 4) {
    s0 = std::fma(a[k * sa], b[k * sb], s0);
    s1 = std::fma(a[(k + 1) * sa], b[(k + 1) * sb], s1);
    s2 = std::fma(a[(k + 2) * sa], b[(k + 2) * sb], s2);
    s3 = std::fma(a[(k + 3) * sa], b[(k + 3) * sb], s3);
  }
  for (; k < len; ++k) s0 = std::fma(a[k * sa], b[k * sb], s0);
  return (s0 + s1) + (s2 + s3);
}

// the two xor shuffles of quad_sum over one quad's partial sums
float quad(const float p[4]) {
  float u[4];
  for (int c = 0; c < 4; ++c) u[c] = p[c] + p[c ^ 1];
  return u[0] + u[2];
}

int fails = 0;
void expect(bool ok, const char* what, int n, int m, int C, int a, int b) {
  if (!ok && fails++ < 20)
    std::printf("FAIL %%s n=%%d m=%%d C=%%d at %%d %%d\n", what, n, m, C, a, b);
}

void once(const std::vector<int>& hits, const char* what, int n, int m, int C) {
  for (size_t k = 0; k < hits.size(); ++k) expect(hits[k] == 1, what, n, m, C, (int)k, hits[k]);
}

// rows_on_quads over a rank's `rows` rows of A (whole rows in A_full from
// row `first` on): quad q of pass e0 takes row e0 + q, lane c its class
// sums; the quad's sum against dot() of the row, each row counted.
void quad_rows(const std::vector<float>& A_full, int first, int rows, int n, int ld,
               const std::vector<float>& v, std::vector<int>& own, const char* what, int m,
               int C) {
  std::vector<float> slab((size_t)(rows > 0 ? rows : 1) * ld);
  for (int e = 0; e < rows; ++e)
    for (int k = 0; k < n; ++k) slab[e * ld + k] = A_full[(first + e) * ld + k];
  for (int e0 = 0; e0 < rows; e0 += NQUADS)
    for (int q = 0; q < NQUADS; ++q) {
      const int e = e0 + q;
      if (e >= rows) continue;
      float p[4];
      for (int c = 0; c < 4; ++c) p[c] = lane_sum(slab.data() + (size_t)e * ld, 1, v.data(), 1, c, n);
      expect(same(quad(p), dot_ref(A_full.data() + (first + e) * ld, 1, v.data(), 1, n)), what, n, m,
             C, first + e, 0);
      ++own[first + e];
    }
}

void check(int n, int m, int C, std::mt19937& gen) {
  const int ld = n | 1;
  std::uniform_real_distribution<float> u(-1.f, 1.f), mag(-6.f, 6.f), dg(0.5f, 2.f);
  auto draw = [&] { return u(gen) * std::exp2(mag(gen)); };
  std::vector<float> P(n * ld), G(m * ld), v(n);
  for (auto& e : P) e = draw();
  for (auto& e : G) e = draw();
  for (auto& e : v) e = draw();
  // the layout: the same offsets on every rank, the rows' blocks in order
  PolishWork w{};
  std::vector<long> offs0;
  size_t fixed = 0;
  for (int rank = 0; rank < C; ++rank) {
    fixed = carve_polish(w, nullptr, n, m, C, rank);
    std::vector<float> buf(RANK_BYTES / sizeof(float));
    carve_polish(w, buf.data(), n, m, C, rank);
    float* f[] = {w.P, w.G, w.M, w.q, w.x, w.xp1, w.xp2, w.u, w.pir, w.dx, w.r1, w.gv, w.px,
                  w.pxo, w.ydiag, w.lo, w.hi, w.y, w.Gx, w.yp1, w.yp2, w.dm, w.bv, w.w, w.dl,
                  w.w2, w.lam, w.r2, (float*)w.idx, w.xchg, w.red, w.arena};
    std::vector<long> offs;
    for (float* p : f) offs.push_back((long)(p - buf.data()));
    if (rank == 0) offs0 = offs;
    expect(offs == offs0, "offsets equal on every rank", n, m, C, rank, 0);
    expect((size_t)offs.back() == fixed && fixed + w.arena_len == RANK_BYTES / sizeof(float),
           "arena after the fixed part", n, m, C, rank, 0);
    expect(offs[1] - offs[0] == (long)rows_per_rank(n, C) * ld &&
               offs[2] - offs[1] == (long)rows_per_rank(m, C) * ld && offs[3] - offs[2] == (long)n * ld,
           "P, G and M sizes", n, m, C, rank, 0);
    const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
    expect(w.n0 == rn.lo && w.n1 == rn.hi && w.m0 == rm.lo && w.m1 == rm.hi, "rows", n, m, C,
           rank, 0);
  }
  std::printf("LAYOUT %%d %%d %%d %%zu %%zu %%d\n", n, m, C, fixed, w.arena_len,
              polish_fits(n, m, C) ? 1 : 0);
  expect(spread_floats(n, m, C) <= w.arena_len, "spread rows at a = m fit", n, m, C, 0, 0);
  int whole = 0;
  while (whole < m && whole_floats(n, whole + 1) <= w.arena_len) ++whole;
  std::printf("WHOLE %%d %%d %%d %%d\n", n, m, C, whole);
  // P v and G v on the rows' owners
  std::vector<int> own_p(n), own_g(m);
  for (int rank = 0; rank < C; ++rank) {
    const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
    quad_rows(P, rn.lo, rn.hi - rn.lo, n, ld, v, own_p, "P v", m, C);
    quad_rows(G, rm.lo, rm.hi - rm.lo, n, ld, v, own_g, "G v", m, C);
  }
  once(own_p, "P v row", n, m, C);
  once(own_g, "G v row", n, m, C);
  // P's factor: Y = L^-1 alone (one CTA) and in M's upper triangle (cluster)
  std::vector<float> L(n * ld, 0.f), Y(n * ld, 0.f), M, ydiag(n);
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < r; ++c) L[r * ld + c] = 0.2f * u(gen);
    L[r * ld + r] = dg(gen);
  }
  one::tri_inverse_cols(L.data(), Y.data(), n, ld);
  M = L;
  one::tri_inverse_upper(M.data(), ydiag.data(), n, ld);
  // apply_pinv through Y against apply_pinv_c through M's upper triangle
  {
    std::vector<float> u1(n), u2(n), o1(n), o2(n);
    one::Work s1{};
    s1.n = n;
    s1.ldn = ld;
    s1.Y = Y.data();
    s1.u = u1.data();
    one::apply_pinv(s1, v.data(), o1.data());
    PolishWork s2{};
    s2.n = n;
    s2.ldn = ld;
    s2.M = M.data();
    s2.u = u2.data();
    one::apply_pinv_c(s2, v.data(), o2.data());
    for (int i = 0; i < n; ++i) expect(same(o1[i], o2[i]), "apply_pinv", n, m, C, i, 0);
  }
  // Vt_a on the ranks' blocks of the active rows: through M's upper
  // triangle and the staged row against Y's row and G's row
  std::uniform_int_distribution<int> pick(0, m - 1);
  const int sizes[] = {0, 1, 7 < m ? 7 : m, whole, m};
  for (int a : sizes) {
    std::vector<int> idx;
    std::vector<char> on(m, 0);
    while ((int)idx.size() < a) {
      const int r = pick(gen);
      if (!on[r]) on[r] = 1, idx.push_back(r);
    }
    idx.clear();
    for (int r = 0; r < m; ++r)
      if (on[r]) idx.push_back(r);  // ascending, as active_rows lists them
    std::vector<float> Ga((size_t)a * ld);
    for (int k = 0; k < a; ++k)
      for (int j = 0; j < n; ++j) Ga[k * ld + j] = G[idx[k] * ld + j];
    std::vector<int> own_vt(a * n), own_s(a * a), copy_s(a * a);
    const bool spread = whole_floats(n, a) > w.arena_len;
    for (int rank = 0; rank < C; ++rank) {
      const RankRows rk = rank_rows(a, C, rank);
      for (int tid = 0; tid < K2_THREADS; ++tid) {
        for (int e = tid; e < (rk.hi - rk.lo) * n; e += K2_THREADS) {
          const int k = rk.lo + e / n, kk = e - (k - rk.lo) * n;
          const float got = dot(M.data() + kk, ld, Ga.data() + k * ld, 1, kk + 1);
          expect(same(got, dot(Y.data() + kk * ld, 1, G.data() + idx[k] * ld, 1, kk + 1)),
                 "Vt_a entry", n, m, C, k, kk);
          ++own_vt[k * n + kk];
        }
        const int i0 = spread ? rk.lo : 0, rows = spread ? rk.hi - rk.lo : a;
        for (int e = tid; e < rows * a; e += K2_THREADS) {
          const int i = i0 + e / a, j = e - (i - i0) * a;
          if (j > i) continue;
          if (spread) ++own_s[i * a + j];
          else if (rank == 0) ++copy_s[i * a + j];
        }
      }
    }
    once(own_vt, "Vt_a entry", n, m, C);
    for (int i = 0; i < a; ++i)
      for (int j = 0; j <= i; ++j)
        expect((spread ? own_s : copy_s)[i * a + j] == 1, "S_aa entry", n, m, C, i, j);
    // spread: the owner's rows of Vt_a and S_aa fit its arena
    const size_t per = rows_per_rank(a, C);
    expect(!spread || per * ((size_t)ld + (a | 1)) <= w.arena_len, "spread rows fit", n, m, C,
           a, 0);
  }
}

int main() {
  std::mt19937 gen(20261018);
  const int cases[][3] = {%(cases)s};
  for (const auto& c : cases) check(c[0], c[1], c[2], gen);
  std::printf("FAILS %%d\n", fails);
  return 0;
}
"""


def _function(src, head):
    """The function starting at the line ``head`` to its closing ``}``."""
    a = src.index(head)
    return src[a:src.index("\n}\n", a) + 3]


@pytest.fixture(scope="module")
def polish(tmp_path_factory):
    """{"layout": {(n, m, C): (fixed, arena, fits)}, "whole": {(n, m, C):
    a}, "fails": [...], "nfail": int} of the test program."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the source's polish split")
    src = SOURCE.read_text()
    consts = "\n".join(re.search(rf"constexpr (int|size_t) {name} = [^;]+;", src).group(0)
                       for name in ("K2_THREADS", "NWARPS", "NQUADS", "MAX_RED", "MAX_RANKS",
                                    "RANK_BYTES"))
    work = src[src.index("struct Work {"):src.index("};", src.index("struct Work {")) + 3]
    prog = PROGRAM % dict(
        consts=consts,
        dot=_cut(src, "__device__ __forceinline__ float dot(const float* a, int sa, const float* b",
                 "__device__ __forceinline__ float dot(const float* a, int sa, const float* v"),
        tiles=_cut(src, "__host__ __device__ inline int tile_row(",
                   "__host__ __device__ inline void g_rows("),
        rows=_cut(src, "struct RankRows {", "__host__ __device__ inline int row_rank("),
        layout=_cut(src, "struct PolishWork {", "__host__ __device__ inline bool polish_fits("),
        work=work,
        inverse=_function(src, "__device__ void tri_inverse_cols("),
        upper=_function(src, "__device__ void tri_inverse_upper("),
        pinv=_function(src, "__device__ void apply_pinv("),
        pinv_c=_function(src, "__device__ void apply_pinv_c("),
        cases=", ".join(f"{{{n}, {m}, {C}}}" for n, m, C in CASES))
    tmp = tmp_path_factory.mktemp("polish")
    cpp, exe = tmp / "polish.cpp", tmp / "polish"
    cpp.write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", str(cpp), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=600).stdout.splitlines()
    layout = {tuple(map(int, ln.split()[1:4])): tuple(map(int, ln.split()[4:])) for ln in out
              if ln.startswith("LAYOUT")}
    whole = {tuple(map(int, ln.split()[1:4])): int(ln.split()[4]) for ln in out
             if ln.startswith("WHOLE")}
    return {"layout": layout, "whole": whole,
            "fails": [ln for ln in out if ln.startswith("FAIL")],
            "nfail": int(next(ln for ln in out if ln.startswith("FAILS")).split()[1])}


def test_every_served_shape_and_cluster_size_was_checked(polish):
    """Every (n, m) the wrappers run the polish on a cluster, at the cluster
    size they pick and each larger one."""
    assert set(polish["layout"]) == set(CASES)
    for n, m in SERVED + WIDE:
        C = max(cluster_size(k, n, m) for k in (K2, AB2))
        assert C > 1 and all((n, m, c) in polish["layout"] for c in range(C, MAX_CLUSTER + 1))
    assert (80, 159, 2) in polish["layout"] and (121, 239, 4) in polish["layout"]


@pytest.mark.parametrize("C", CLUSTERS)
def test_every_polish_entry_has_one_owner_and_each_sum_is_dot_bit_for_bit(polish, C):
    """(The failures listed are the first 20 over all C.)"""
    assert any(c == C for _, _, c in polish["layout"])
    assert polish["nfail"] == 0, polish["fails"]


@pytest.mark.parametrize("n,m", SERVED[::8] + [(80, 159), (121, 239)] + WIDE)
def test_the_layout_is_the_python_count(polish, n, m):
    """The floats before the arena, and the active rows kept whole, equal
    ``ops/admm.py``'s count at each cluster size; the arena holds the rows
    spread at a = m (checked in the program too)."""
    for C in CLUSTERS:
        if (n, m, C) not in polish["layout"]:
            assert admm.polish_layout(n, m, C) is None
            continue
        fixed, arena, fits = polish["layout"][(n, m, C)]
        assert fits == 1 and fixed == admm.polish_layout(n, m, C)
        assert fixed + arena == admm.SMEM_LIMIT // 4
        assert polish["whole"][(n, m, C)] == whole_active_rows(n, m, C)
        assert -(-m // C) * ((n | 1) + (m | 1)) <= arena
    # at T=40 on two ranks the accepted polishes' a (p99 55, max 61 on the
    # headline tick, PERF.md) stay well below the rows kept whole
    assert polish["whole"].get((80, 159, 2), 131) == 131
