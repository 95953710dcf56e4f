"""PyTorch port, K2 / A/B-1 on a cluster: the ADMM phase split by output rows
over the cluster's ranks, compiled from ``csrc/admm.cu`` on the host.

Past one CTA's shared memory K2 and A/B-1 run a scenario on a cluster of
C = 2-4 CTAs, and every rank computes the ADMM phase on its own rows
(``carve_split``, ``ruiz_admm_split``): rank r owns the block ``rank_rows``
of the n rows and of the m rows, forms G't and M^-1 rhs on its n rows and
G xt on its m rows (each entry on one quad in dot()'s order, the rank's
rows in the cluster buckets' register tiles), forms M and G'G on its rows
(the other ranks' columns of G staged into M), M^-1 on its rows (from Y = L^-1 kept in
M's upper triangle), and takes the residual check on its rows. No sum is
split between ranks, so each entry is the single-CTA kernel's.

These tests cut the source's ownership (``rows_per_rank``, ``rank_rows``,
``row_rank``), its tile map (``tile_row`` .. ``g_rows``), its buckets
(``BucketC40``, ``BucketC60``, ``in_c40``), ``dot``, ``tri_inverse_cols``,
``gram_lower``, ``tri_inverse_upper``, ``gram_rows`` and the split layout
(``xchg_len``, ``carve_split``) out of ``csrc/admm.cu``, compile them with
g++ at ``-ffp-contract=off`` and, at every (n, m) the wrappers run on a
cluster (K2 at T = 32-63, canonical and jerk; A/B-1 at T = 38-68, both),
at problems wider than the controller's (``WIDE``: m up to 25 n, n down to
2, which the wrappers also put on a cluster) and C = 2, 3, 4, emulate each
rank's 256 threads as ``admm_iterate_split``, ``factorize_split``,
``gram_split`` and ``admm_residuals_split`` place them, and hold:

- every output entry of every phase (G't and M^-1 rhs on the n rows, G xt
  with its z, y and t update on the m rows, the residual rows, M's lower
  triangle, G'G's lower triangle, M^-1 whole, G's columns written into
  their owners' G') owned by exactly one rank (and one quad or thread),
  and another rank's rows of G' fitting the rank's M in ``carve_split``'s
  layout, where G'G stages them;
- each owned sum of the iteration, in the quad placement with the rank's
  tiles, equal to ``dot()``'s order (``s_c = fma(a, b, s_c)``, the tail
  into s0, (s0 + s1) + (s2 + s3)) bit for bit on random float32 data;
- the inverse kept in M's upper triangle and M^-1 formed from it on a
  rank's rows equal to ``tri_inverse_cols`` and ``gram_lower`` on the
  single CTA's layout bit for bit;
- at the cluster size the wrappers pick, every phase in one pass of the
  64 quads up to T = 60, with whole rows in the registers.
"""

import re
import shutil
import subprocess

import pytest

from mpc_for_av_at_intersection_tpu_torch.ops.admm import AB1, K2, cluster_size

from test_torch_admm_smem import SOURCE, _dims
from test_torch_admm_tiles import _cut

# (n, m) the wrappers run on a cluster at the controller's horizons, and
# every cluster size
SERVED = sorted({_dims(T, jerk) for T in range(32, 64) for jerk in (False, True)}
                | {_dims(T, jerk) for T in range(38, 69) for jerk in (False, True)})
# wider problems the wrappers also run on a cluster: K2 and A/B-2 at m = 6n
# (two CTAs), A/B-1 at m = 15n, 25n and 30n (two, three and four CTAs) and
# at n = 2 (an exchange slot longer than 2n)
WIDE = [(40, 240), (40, 600), (40, 1000), (40, 1200), (2, 5000)]
CASES = SERVED + WIDE
CLUSTERS = (2, 3, 4)

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
%(buckets)s
%(rows)s
// the single-thread run of the source's factor helpers: one "thread" walks
// every column and entry, so each barrier falls between two whole phases
namespace one {
constexpr int K2_THREADS = 1;
%(split_work)s
%(inverse)s
%(gram_lower)s
%(upper)s
%(gram_rows)s
%(carve_split)s
}  // namespace one

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

bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }

int fails = 0;
void expect(bool ok, const char* what, int n, int C, int a, int b) {
  if (!ok && fails++ < 20) std::printf("FAIL %%s n=%%d C=%%d at %%d %%d\n", what, n, C, a, b);
}

// Every entry's owner count equal to 1.
void once(const std::vector<int>& hits, const char* what, int n, int C) {
  for (size_t k = 0; k < hits.size(); ++k) expect(hits[k] == 1, what, n, C, (int)k, hits[k]);
}

// One rank's iteration in the quad placement of admm_iterate_split: its
// register tiles loaded as there, each phase's owned entries summed and
// held to dot_ref; owner counts into own_rhs (n), own_g (m).
template <class Bk>
void iterate_rank(int n, int m, int C, int rank, const std::vector<float>& G, int ld,
                  const std::vector<float>& Mi, const std::vector<float>& t,
                  const std::vector<float>& v, const std::vector<float>& x,
                  std::vector<int>& own_rhs, std::vector<int>& own_xt, std::vector<int>& own_g,
                  int& passes) {
  const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
  const int n0 = rn.lo, m0 = rm.lo, pn = rn.hi - n0, pm = rm.hi - m0, ldt = m | 1;
  // the rank's slabs: G' rows (G's columns), M^-1 rows, G rows
  std::vector<float> GT((size_t)rows_per_rank(n, C) * ldt), Ms((size_t)rows_per_rank(n, C) * ld),
      Gs((size_t)rows_per_rank(m, C) * ld);
  for (int li = 0; li < pn; ++li) {
    for (int r = 0; r < m; ++r) GT[li * ldt + r] = G[r * ld + n0 + li];
    for (int k = 0; k < n; ++k) Ms[li * ld + k] = Mi[(n0 + li) * ld + k];
  }
  for (int lr = 0; lr < pm; ++lr)
    for (int k = 0; k < n; ++k) Gs[lr * ld + k] = G[(m0 + lr) * ld + k];
  static float gt[K2_THREADS][Bk::kSjM], gtt[K2_THREADS][3], mi[K2_THREADS][Bk::kSjN],
      g[K2_THREADS][Bk::kSjN];
  const bool extra = extra_in_mi(pn, pm);
  for (int tid = 0; tid < K2_THREADS; ++tid) {
    const int q = tid >> 2, cls = tid & 3, we = extra_row(q, pn);
    load_row(gt[tid], GT.data(), ldt, 1, q, pn, m, cls);
    load_tail(gtt[tid], GT.data(), ldt, 1, q, pn, m, cls);
    load_row(mi[tid], Ms.data(), ld, 1, q, pn, n, cls);
    load_row(g[tid], Gs.data(), ld, 1, q, pm, n, cls);
    if (extra && q >= pn && we < pm) load_row(mi[tid], Gs.data(), ld, 1, we, pm, n, cls);
  }
  const int ngt = tile_len(Bk::kSjM, m), nn = tile_len(Bk::kSjN, n);
  int slots = 0;
  for (int sl = 0; tile_row(0, sl) < pn; ++sl, ++slots)
    for (int q = 0; q < NQUADS; ++q) {
      const int li = tile_row(q, sl);
      if (li >= pn) continue;
      float p[4], r[4];
      for (int c = 0; c < 4; ++c) {
        const int tid = 4 * q + c;
        p[c] = sl == 0 ? lane_sum(gt[tid], ngt, GT.data() + li * ldt, 1, t.data(), 1, c, m, gtt[tid])
                       : lane_sum(GT.data() + li * ldt, 1, t.data(), 1, c, m);
        r[c] = sl == 0 ? lane_sum(mi[tid], nn, Ms.data() + li * ld, 1, v.data(), 1, c, n)
                       : lane_sum(Ms.data() + li * ld, 1, v.data(), 1, c, n);
      }
      const int i = n0 + li;
      expect(same(quad(p), dot_ref(G.data() + i, ld, t.data(), 1, m)), "G't", n, C, i, rank);
      expect(same(quad(r), dot_ref(Mi.data() + i * ld, 1, v.data(), 1, n)), "M^-1 v", n, C, i,
             rank);
      ++own_rhs[i];
      ++own_xt[i];
    }
  int gslots = 1;
  for (int q = 0; q < NQUADS; ++q) {
    const int we = extra_row(q, pn);
    const bool has_e = extra && q >= pn && we < pm;
    float p0[4], p1[4];
    for (int c = 0; c < 4; ++c)
      g_rows(p0[c], p1[c], g[4 * q + c], mi[4 * q + c], has_e, nn, Gs.data(), ld, q, we, pm,
             x.data(), c, n);
    if (q < pm) {
      expect(same(quad(p0), dot_ref(G.data() + (m0 + q) * ld, 1, x.data(), 1, n)), "G x", n, C,
             m0 + q, rank);
      ++own_g[m0 + q];
    }
    if (has_e) {
      expect(same(quad(p1), dot_ref(G.data() + (m0 + we) * ld, 1, x.data(), 1, n)), "G x extra",
             n, C, m0 + we, rank);
      ++own_g[m0 + we];
    }
  }
  if (!extra)
    for (int sl = 1; tile_row(0, sl) < pm; ++sl, ++gslots)
      for (int q = 0; q < NQUADS; ++q) {
        const int lw = tile_row(q, sl);
        if (lw >= pm) continue;
        float p[4];
        for (int c = 0; c < 4; ++c) p[c] = lane_sum(Gs.data() + lw * ld, 1, x.data(), 1, c, n);
        expect(same(quad(p), dot_ref(G.data() + (m0 + lw) * ld, 1, x.data(), 1, n)),
               "G x past the tiles", n, C, m0 + lw, rank);
        ++own_g[m0 + lw];
      }
  passes = passes > slots ? passes : slots;
  passes = passes > gslots ? passes : gslots;
}

// The owners of the phases around the iteration: the residual rows, M's
// rows (factorize_split), G'G's entries (gram_split), M^-1's rows
// (gram_rows) and G's columns in their owners' G' (the scaled problem).
void owners(int n, int m, int C) {
  std::vector<int> res_m(m), res_n(n), mrow(n * n), gtg(n * n), mi(n * n), gt(n * m);
  const int per = rows_per_rank(n, C);
  for (int rank = 0; rank < C; ++rank) {
    const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
    one::SplitWork w{};  // the rank's layout: M's floats, up to M^-1's slab
    std::vector<float> layout(one::carve_split(w, nullptr, n, m, C, rank));
    one::carve_split(w, layout.data(), n, m, C, rank);
    const long m_floats = (long)(w.Mi - w.M);
    for (int tid = 0; tid < K2_THREADS; ++tid) {
      const int lane = tid & 31;
      for (int r = rm.lo + tid; r < rm.hi; r += K2_THREADS) ++res_m[r];
      for (int i = rn.lo + tid; i < rn.hi; i += K2_THREADS) ++res_n[i];
      for (int i = rn.lo + (tid >> 5); i < rn.hi; i += NWARPS)
        for (int j = lane; j <= i; j += 32) ++mrow[i * n + j];
      for (int q = 0; q < C; ++q) {  // gram_split: rank q's G' rows staged into M
        const RankRows rq = rank_rows(n, C, q);
        const int qn = rq.hi - rq.lo;
        if (rq.lo >= rn.hi) break;
        expect(q == rank || (long)qn * (m | 1) <= m_floats, "G' rows staged in M", n, C, q,
               qn);
        for (int e = tid; e < (rn.hi - rn.lo) * qn; e += K2_THREADS) {
          const int i = rn.lo + e / qn, j = rq.lo + e %% qn;
          if (j <= i) {
            expect(row_rank(i, n, C) == rank && row_rank(j, n, C) == q, "G'G owner", n, C, i, j);
            ++gtg[i * n + j];
          }
        }
      }
      for (int e = tid; e < (rn.hi - rn.lo) * n; e += K2_THREADS) ++mi[(rn.lo + e / n) * n + e %% n];
      for (int e = tid; e < (rm.hi - rm.lo) * n; e += K2_THREADS) {
        const int r = rm.lo + e / n, j = e %% n, q = j / per;
        expect(q < C && j - q * per < rank_rows(n, C, q).hi - rank_rows(n, C, q).lo, "G' owner", n,
               C, r, j);
        ++gt[j * m + r];
      }
    }
  }
  once(res_m, "residual m rows", n, C);
  once(res_n, "residual n rows", n, C);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) {
      expect(mrow[i * n + j] == 1, "M row", n, C, i, j);
      expect(gtg[i * n + j] == 1, "G'G entry", n, C, i, j);
    }
  once(mi, "M^-1 entry", n, C);
  once(gt, "G' entry", n, C);
}

// Y = L^-1 in M's upper triangle and M^-1 on each rank's rows against
// tri_inverse_cols and gram_lower on the single CTA's layout.
void inverse(int n, int C, std::mt19937& gen) {
  const int ld = n | 1;
  std::uniform_real_distribution<float> u(-1.f, 1.f), dg(0.5f, 2.f);
  std::vector<float> L(n * ld, 0.f), Y(n * ld, 0.f), Mi(n * ld, 0.f), M;
  for (int r = 0; r < n; ++r) {
    for (int c = 0; c < r; ++c) L[r * ld + c] = 0.2f * u(gen);
    L[r * ld + r] = dg(gen);
  }
  one::tri_inverse_cols(L.data(), Y.data(), n, ld);
  one::gram_lower(Y.data(), Mi.data(), n, ld);
  M = L;
  std::vector<float> ydiag(n), slab((size_t)rows_per_rank(n, C) * ld);
  one::tri_inverse_upper(M.data(), ydiag.data(), n, ld);
  for (int r = 0; r < n; ++r)
    for (int c = 0; c <= r; ++c) expect(same(M[c * ld + r], Y[r * ld + c]), "Y in M", n, C, r, c);
  for (int rank = 0; rank < C; ++rank) {
    one::SplitWork s{};
    const RankRows rn = rank_rows(n, C, rank);
    s.n = n;
    s.ldn = ld;
    s.n0 = rn.lo;
    s.n1 = rn.hi;
    s.M = M.data();
    s.Mi = slab.data();
    one::gram_rows(s);
    for (int i = rn.lo; i < rn.hi; ++i)
      for (int k = 0; k < n; ++k)
        expect(same(slab[(i - rn.lo) * ld + k], Mi[i * ld + k]), "M^-1 row", n, C, i, k);
  }
}

template <class Bk>
void check(int n, int m, int C, std::mt19937& gen, int& passes) {
  const int ld = n | 1;
  std::uniform_real_distribution<float> u(-1.f, 1.f), mag(-6.f, 6.f);
  auto draw = [&] { return u(gen) * std::exp2(mag(gen)); };
  std::vector<float> G(m * ld), Mi(n * ld), t(m), v(n), x(n);
  for (auto& e : G) e = draw();
  for (auto& e : Mi) e = draw();
  for (auto& e : t) e = draw();
  for (auto& e : v) e = draw();
  for (auto& e : x) e = draw();
  std::vector<int> own_rhs(n), own_xt(n), own_g(m);
  for (int rank = 0; rank < C; ++rank)
    iterate_rank<Bk>(n, m, C, rank, G, ld, Mi, t, v, x, own_rhs, own_xt, own_g, passes);
  once(own_rhs, "rhs entry", n, C);
  once(own_xt, "xt entry", n, C);
  once(own_g, "G xt row", n, C);
  owners(n, m, C);
}

int main() {
  std::mt19937 gen(20261018);
  const int cases[][3] = {%(cases)s};
  for (const auto& c : cases) {
    const int n = c[0], m = c[1], C = c[2];
    int passes = 0;
    if (in_c40(n, m)) check<BucketC40>(n, m, C, gen, passes);
    else check<BucketC60>(n, m, C, gen, passes);
    inverse(n, C, gen);
    std::printf("CASE %%d %%d %%d %%d %%d\n", n, m, C, in_c40(n, m) ? 40 : 60, passes);
  }
  std::printf("BUCKET 40 %%d %%d %%d %%d %%d\n", BucketC40::kN, BucketC40::kM, BucketC40::kSjN,
              BucketC40::kSjM, BucketC40::kCtas);
  std::printf("BUCKET 60 %%d %%d %%d %%d %%d\n", BucketC60::kN, BucketC60::kM, BucketC60::kSjN,
              BucketC60::kSjM, BucketC60::kCtas);
  std::printf("FAILS %%d\n", fails);
  return 0;
}
"""


def _function(src, head):
    """The function starting at the line ``head`` to its closing ``}``."""
    a = src.index(head)
    return src[a:src.index("\n}\n", a) + 3]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """{"cases": {(n, m, C): (bucket, passes)}, "buckets": {40: (kN, kM,
    kSjN, kSjM, kCtas), 60: ...}, "fails": [...], "nfail": int}."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the source's split")
    src = SOURCE.read_text()
    consts = "\n".join(re.search(rf"constexpr int {name} = [^;]+;", src).group(0)
                       for name in ("K2_THREADS", "NWARPS", "NQUADS", "MAX_RED"))
    prog = PROGRAM % dict(
        consts=consts,
        dot=_cut(src, "__device__ __forceinline__ float dot(const float* a, int sa, const float* b",
                 "__device__ __forceinline__ float dot(const float* a, int sa, const float* v"),
        tiles=_cut(src, "__host__ __device__ inline int tile_row(",
                   "__host__ __device__ inline void g_rows("),
        buckets=(_cut(src, "template <int N_MAX, int M_MAX, int CTAS>", "inline bool in_t13(")
                 + _cut(src, "using BucketC40 =", "inline bool in_c40(")),
        rows=_cut(src, "struct RankRows {", "__host__ __device__ inline int row_rank("),
        split_work=src[src.index("struct SplitWork {"):src.index("};", src.index("struct SplitWork {"))
                       + 3],
        inverse=_function(src, "__device__ void tri_inverse_cols("),
        gram_lower=_function(src, "__device__ void gram_lower("),
        upper=_function(src, "__device__ void tri_inverse_upper("),
        gram_rows=_function(src, "__device__ void gram_rows("),
        carve_split=_function(src, "__host__ __device__ inline int xchg_len("),
        cases=", ".join(f"{{{n}, {m}, {C}}}" for n, m in CASES for C in CLUSTERS))
    tmp = tmp_path_factory.mktemp("split")
    cpp, exe = tmp / "split.cpp", tmp / "split"
    cpp.write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", str(cpp), "-o", str(exe)],
                   check=True, capture_output=True, timeout=300)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=600).stdout.splitlines()
    cases = {tuple(map(int, ln.split()[1:4])): tuple(map(int, ln.split()[4:])) for ln in out
             if ln.startswith("CASE")}
    buckets = {int(ln.split()[1]): tuple(map(int, ln.split()[2:])) for ln in out
               if ln.startswith("BUCKET")}
    return {"cases": cases, "buckets": buckets,
            "fails": [ln for ln in out if ln.startswith("FAIL")],
            "nfail": int(next(ln for ln in out if ln.startswith("FAILS")).split()[1])}


def test_every_served_shape_and_cluster_size_was_checked(split):
    assert set(split["cases"]) == {(n, m, C) for n, m in CASES for C in CLUSTERS}
    assert len(SERVED) == 2 * len(range(32, 69))
    for n, m in WIDE:
        assert max(cluster_size(k, n, m) for k in (K2, AB1)) > 1, (n, m)


@pytest.mark.parametrize("C", CLUSTERS)
def test_every_entry_has_one_owner_and_each_sum_is_dot_bit_for_bit(split, C):
    """At every served and wide (n, m) on C ranks: each entry of G't, M^-1 rhs and
    G xt owned by one quad of one rank and equal to ``dot()``'s order bit
    for bit, the residual rows, M's and G'G's lower triangles, M^-1 and G'
    owned once, and M^-1 from the inverse in M's upper triangle equal to
    the single CTA's. (The failures listed are the first 20 over all C.)"""
    assert all((n, m, C) in split["cases"] for n, m in CASES)
    assert split["nfail"] == 0, split["fails"]


def test_the_cluster_buckets_hold_whole_rows_in_one_pass_where_the_wrappers_run(split):
    """At the cluster size the wrappers pick (K2 and A/B-1 up to T=60) the
    bucket's tiles hold whole rows (G''s rows of m with lane 0's tail of up
    to 3, M^-1's and G's rows of n), and every phase takes one pass of the
    64 quads at T=40 (two ranks, canonical and jerk) and T=60 (K2 on four,
    A/B-1 on three), two at most elsewhere (a rank's m rows past the 64
    quads that the quads past its n rows cannot hold, as K2 at T=43 and
    T=48 on two); past T=60 (K2 to T=63, A/B-1 to 68) a row's rest is read
    from shared memory in the same order. The two buckets:
    T <= 40 and T <= 60, one CTA an SM (255 registers a thread); their
    tiles take at most 125 floats a lane."""
    assert split["buckets"][40] == (83, 159, 20, 39, 1)
    assert split["buckets"][60] == (123, 239, 30, 59, 1)
    for kN, kM, kSjN, kSjM, ctas in split["buckets"].values():
        assert kSjM + 3 + 2 * kSjN <= 125
    for n, m in SERVED:
        T = (m + 1) // 4
        for kernel in (K2, AB1):
            C = cluster_size(kernel, n, m)
            if C < 2 or T > 60:
                continue
            bucket, passes = split["cases"][(n, m, C)]
            kN, kM, kSjN, kSjM, _ = split["buckets"][bucket]
            assert n <= kN and m <= kM and 4 * kSjM + 3 >= m and 4 * kSjN + 3 >= n, (n, m)
            one_pass = T in (40, 60)
            assert passes == 1 if one_pass else passes <= 2, (kernel, n, m, C, passes)
