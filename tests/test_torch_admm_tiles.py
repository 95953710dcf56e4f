"""PyTorch port, K2 / A/B-1: the quad placement of the ADMM phase's dot
products, compiled from ``csrc/admm.cu`` on the host.

The ADMM phase of K2, A/B-1 and the probes gives each output entry of a
matvec a quad of four lanes: lane c sums the residue class k = c + 4j of
the dot product in ascending j, lane 0 adds the len mod 4 tail, and two
xor shuffles give (s0 + s1) + (s2 + s3), which is ``dot()``'s value bit for
bit as long as every product-add is the same fused multiply-add. The
iteration holds its matrices in register tiles (``load_row``): G by rows
(its rows past 64 in the M^-1 registers of the quads past n), G' by rows
and M^-1 by rows, sized per horizon bucket (``Bucket``); what does not fit
is read from shared memory in the same order (``lane_rest``).

These tests cut the tile map (``tile_row``, ``tile_entry``, ``tile_len``,
``load_row``, ``load_tail``, ``lane_rest``, ``lane_sum``, ``extra_in_mi``,
``g_rows``) and the buckets out of the source, compile them with g++ at
``-ffp-contract=off`` (``fmaf`` where the kernel spells its fused
multiply-adds out), and hold, at T = 5, 13, 20, 21, 31 and 37 with n = 2T
and 2T + 1 and m = 4T - 1, in both buckets' tiles:

- G x, G' t and M^-1 v, summed in the placement, to a CPU copy of
  ``dot``'s order (``s_c = fma(a, b, s_c)``, the tail into s0, (s0 + s1) +
  (s2 + s3)), bit for bit, on random float32 data (G'G and Y'Y keep
  ``dot`` itself, one thread per entry: in the quad placement they were
  measured slower);
- every matrix entry read exactly once per matvec, from a register tile
  or from shared memory;
- each bucket's register tiles and shared memory within the CTAs per SM
  it is launched at (A/B-1 and the probes: four at T <= 13, three at
  T = 20), and the bucket that ``in_t13`` picks at each horizon.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from mpc_for_av_at_intersection_tpu_torch.ops import admm
from mpc_for_av_at_intersection_tpu_torch.ops.admm import AB1, K2, PROBE3, PROBE12, smem_bytes

SOURCE = Path(admm.__file__).resolve().parent.parent / "csrc" / "admm.cu"
HORIZONS = (5, 13, 20, 21, 31, 37)
SM_SHARED = 233472          # bytes of shared memory an H100 SM has for its CTAs
CTA_RESERVED = 1024         # bytes the runtime reserves for each CTA
REGISTERS = 65536           # 32-bit registers an SM has
THREADS = 256               # csrc/admm.cu K2_THREADS

# The test program: the source's tile map and buckets, a counting accessor,
# today's dot order, and a quad emulation of each matvec.
PROGRAM = r"""
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>
#define __host__
#define __device__
%(consts)s
%(tiles)s
%(buckets)s

// a[k] that counts its reads
struct Rec {
  const float* base;
  int* hits;
  float operator[](int k) const { ++hits[k]; return base[k]; }
  Rec operator+(int k) const { return {base + k, hits + k}; }
};

// today's dot(): four partial sums, the tail into s0
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
bool quad_equal(const float p[4], float want) {
  float u[4], w[4];
  for (int c = 0; c < 4; ++c) u[c] = p[c] + p[c ^ 1];
  for (int c = 0; c < 4; ++c) w[c] = u[c] + u[c ^ 2];
  for (int c = 0; c < 4; ++c)
    if (std::memcmp(&w[c], &want, 4) != 0) return false;
  return true;
}

int fails = 0;
void expect(bool ok, const char* what, int T, int n, int a, int b) {
  if (!ok && fails++ < 20) std::printf("FAIL %%s T=%%d n=%%d at %%d %%d\n", what, T, n, a, b);
}

// Every entry (r, k) of an R x L matrix laid out as A[r * srow + k * sent]
// read exactly once.
void expect_once(const std::vector<int>& hits, int R, int L, int srow, int sent, const char* what,
                 int T, int n) {
  int total = 0;
  for (int v : hits) total += v;
  expect(total == R * L, what, T, n, total, R * L);
  for (int r = 0; r < R; ++r)
    for (int k = 0; k < L; ++k) expect(hits[r * srow + k * sent] == 1, what, T, n, r, k);
}

// The iteration's G' t and M^-1 v in the placement, as admm_iterate runs
// them: every thread's register tile loaded once (load_row, and for G' the
// tail of load_tail), then each row's quad: slot 0 from registers, later
// slots and the tail from "shared memory". Each quad's sum is held to
// dot_ref and every matrix entry must be read exactly once.
template <int SJ, bool TAIL>
void matvec(const char* what, const float* A, int srow, int sent, int R, int L, const float* vec,
            int size, int T, int n) {
  static float tl[K2_THREADS][SJ], tails[K2_THREADS][3];
  std::vector<int> hits(size);
  for (int tid = 0; tid < K2_THREADS; ++tid) {
    load_row(tl[tid], Rec{A, hits.data()}, srow, sent, tid >> 2, R, L, tid & 3);
    if (TAIL) load_tail(tails[tid], Rec{A, hits.data()}, srow, sent, tid >> 2, R, L, tid & 3);
  }
  const int nreg = tile_len(SJ, L);
  for (int quad = 0; quad < NQUADS; ++quad)
    for (int s = 0; tile_row(0, s) < R; ++s) {
      const int i = tile_row(quad, s);
      if (i >= R) continue;
      float p[4];
      for (int c = 0; c < 4; ++c) {
        const Rec row = Rec{A, hits.data()} + i * srow;
        p[c] = s == 0 ? lane_sum(tl[4 * quad + c], nreg, row, sent, vec, 1, c, L,
                                 TAIL ? tails[4 * quad + c] : nullptr)
                      : lane_sum(row, sent, vec, 1, c, L);
      }
      expect(quad_equal(p, dot_ref(A + i * srow, sent, vec, 1, L)), what, T, n, i, s);
    }
  expect_once(hits, R, L, srow, sent, what, T, n);
}

// G x by rows as admm_iterate sums G xt: row quad from the quad's G tile
// and, where extra_in_mi, row extra_row(quad, n) from the M^-1 tile
// registers of a quad past n (g_rows, the two rows sharing each vector
// load); otherwise rows past NQUADS from "shared memory".
template <int SJ>
void g_matvec(const float* G, int ld, int m, int n, const float* x, int T) {
  static float g[K2_THREADS][SJ], e[K2_THREADS][SJ];
  std::vector<int> hits(m * ld);
  const Rec A{G, hits.data()};
  const bool extra = extra_in_mi(n, m);
  for (int tid = 0; tid < K2_THREADS; ++tid) {
    const int quad = tid >> 2, we = extra_row(quad, n);
    load_row(g[tid], A, ld, 1, quad, m, n, tid & 3);
    if (extra && quad >= n && we < m) load_row(e[tid], A, ld, 1, we, m, n, tid & 3);
  }
  const int nreg = tile_len(SJ, n);
  for (int quad = 0; quad < NQUADS; ++quad) {
    const int we = extra_row(quad, n);
    const bool has_e = extra && quad >= n && we < m;
    float p0[4], p1[4];
    for (int c = 0; c < 4; ++c)
      g_rows(p0[c], p1[c], g[4 * quad + c], e[4 * quad + c], has_e, nreg, A, ld, quad, we, m,
             x, c, n);
    if (quad < m) expect(quad_equal(p0, dot_ref(G + quad * ld, 1, x, 1, n)), "G x", T, n, quad, 0);
    if (has_e) expect(quad_equal(p1, dot_ref(G + we * ld, 1, x, 1, n)), "G x extra", T, n, we, 1);
    if (!extra)
      for (int s = 1; tile_row(0, s) < m; ++s) {
        const int w = tile_row(quad, s);
        if (w >= m) continue;
        float p[4];
        for (int c = 0; c < 4; ++c) p[c] = lane_sum(A + w * ld, 1, x, 1, c, n);
        expect(quad_equal(p, dot_ref(G + w * ld, 1, x, 1, n)), "G x past the tiles", T, n, w, s);
      }
  }
  expect_once(hits, m, n, ld, 1, "G x reads", T, n);
}

template <class Bk>
void check(int T, int n, std::mt19937& gen) {
  const int m = 4 * T - 1, ld = n | 1;
  std::uniform_real_distribution<float> u(-1.f, 1.f), mag(-6.f, 6.f);
  auto draw = [&] { return u(gen) * std::exp2(mag(gen)); };
  std::vector<float> G(m * ld), Mi(n * ld), x(n), t(m), v(n);
  for (auto& e : G) e = draw();
  for (auto& e : Mi) e = draw();
  for (auto& e : x) e = draw();
  for (auto& e : t) e = draw();
  for (auto& e : v) e = draw();
  g_matvec<Bk::kSjN>(G.data(), ld, m, n, x.data(), T);
  matvec<Bk::kSjM, true>("G' t", G.data(), 1, ld, n, m, t.data(), m * ld, T, n);
  matvec<Bk::kSjN, false>("M^-1 v", Mi.data(), ld, 1, n, n, v.data(), n * ld, T, n);
}

int main() {
  std::mt19937 gen(20261017);
  const int horizons[] = {%(horizons)s};
  for (int T : horizons)
    for (int n : {2 * T, 2 * T + 1}) {
      check<BucketT13>(T, n, gen);
      check<BucketT20>(T, n, gen);
      std::printf("CASE %%d %%d %%d\n", T, n, in_t13(n, 4 * T - 1) ? 13 : 20);
    }
  std::printf("BUCKET 13 %%d %%d %%d %%d %%d\n", BucketT13::kN, BucketT13::kM, BucketT13::kSjN,
              BucketT13::kSjM, BucketT13::kCtas);
  std::printf("BUCKET 20 %%d %%d %%d %%d %%d\n", BucketT20::kN, BucketT20::kM, BucketT20::kSjN,
              BucketT20::kSjM, BucketT20::kCtas);
  std::printf("FAILS %%d\n", fails);
  return 0;
}
"""


def _cut(src, start, end_marker):
    """From the line holding ``start`` to the end of the first top-level
    ``}`` block at or after ``end_marker``."""
    a = src.index(start)
    b = src.index("\n}\n", src.index(end_marker, a)) + 3
    return src[a:b]


@pytest.fixture(scope="module")
def placement(tmp_path_factory):
    """The test program's output: {"cases": [(T, n, bucket)], "buckets":
    {13: (kN, kM, kSjN, kSjM, kCtas), 20: (...)}, "fails": [...]}."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the source's tile map")
    src = SOURCE.read_text()
    consts = "\n".join(re.search(rf"constexpr int {name} = [^;]+;", src).group(0)
                       for name in ("K2_THREADS", "NWARPS", "NQUADS"))
    tiles = _cut(src, "__host__ __device__ inline int tile_row(",
                 "__host__ __device__ inline void g_rows(")
    buckets = _cut(src, "template <int N_MAX, int M_MAX, int CTAS>", "inline bool in_t13(")
    prog = PROGRAM % dict(consts=consts, tiles=tiles, buckets=buckets,
                          horizons=", ".join(map(str, HORIZONS)))
    tmp = tmp_path_factory.mktemp("tiles")
    cpp, exe = tmp / "tiles.cpp", tmp / "tiles"
    cpp.write_text(prog)
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", str(cpp), "-o", str(exe)],
                   check=True, capture_output=True, timeout=180)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=300).stdout.splitlines()
    cases = [tuple(map(int, ln.split()[1:])) for ln in out if ln.startswith("CASE")]
    buckets = {int(ln.split()[1]): tuple(map(int, ln.split()[2:])) for ln in out
               if ln.startswith("BUCKET")}
    fails = [ln for ln in out if ln.startswith("FAIL")]
    nfail = int(next(ln for ln in out if ln.startswith("FAILS")).split()[1])
    return {"cases": cases, "buckets": buckets, "fails": fails, "nfail": nfail}


def test_every_horizon_was_checked(placement):
    assert [c[:2] for c in placement["cases"]] == [(T, n) for T in HORIZONS
                                                   for n in (2 * T, 2 * T + 1)]


def test_placement_sums_are_todays_dot_bit_for_bit(placement):
    """G x, G' t and M^-1 v in both buckets' tiles at every horizon: each
    quad's (s0 + s1) + (s2 + s3) equals ``dot``'s value, and each matrix
    entry is read once."""
    assert placement["nfail"] == 0, placement["fails"]


@pytest.mark.parametrize("T", HORIZONS)
def test_the_bucket_in_t13_picks(placement, T):
    """T <= 13 (the fleet's horizon, canonical and jerk) takes the T = 13
    tiles, every larger horizon the T = 20 ones."""
    want = 13 if T <= 13 else 20
    assert [b for t, _, b in placement["cases"] if t == T] == [want, want]


@pytest.mark.parametrize("bucket", [13, 20])
def test_bucket_tiles_and_shared_memory_fit_its_ctas_per_sm(placement, bucket):
    """The bucket's register tiles (G: kSjN, G': kSjM and its tail of 3,
    M^-1: kSjN floats a thread) take at most five eighths of the registers
    a thread has at the bucket's CTAs per SM, leaving the rest of the
    iteration its own; A/B-1's and the probes' shared memory at the
    bucket's largest horizon fits that many CTAs an SM, and K2's one
    fewer."""
    kN, kM, kSjN, kSjM, ctas = placement["buckets"][bucket]
    assert (kN, kM) == ((27, 51) if bucket == 13 else (43, 79))
    assert ctas == (4 if bucket == 13 else 3)
    cap = REGISTERS // (THREADS * ctas) // 8 * 8
    tiles = kSjN + kSjM + 3 + kSjN
    assert 8 * tiles <= 5 * cap, (tiles, cap)
    T = (kM + 1) // 4
    for n in (2 * T, 2 * T + 1):
        for kernel, k_ctas in ((AB1, ctas), (PROBE3, ctas), (PROBE12, ctas), (K2, ctas - 1)):
            assert k_ctas * (smem_bytes(kernel, n, kM) + CTA_RESERVED) <= SM_SHARED, (kernel, n)
