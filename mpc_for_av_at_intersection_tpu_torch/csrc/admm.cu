// The box-QP solve of the controller tick, three kernels over one set of
// device functions:
//   K2    solve_polish_kernel: modified Ruiz equilibration, warm-started
//         adaptive ADMM and the two-attempt active-set polish, one launch;
//   A/B-1 ruiz_admm_kernel: Ruiz + adaptive ADMM alone (the unpolished
//         solve, and the first half of the two-launch twin of K2);
//   A/B-2 polish_select_kernel: the polish alone, on an ADMM solution;
// and the per-stage profile's three ADMM probes over the same helpers
// (Probe-1/2/3, described where they are defined below).
//
// Replaces the TPU kernels of mpc_for_av_at_intersection_tpu/ops/admm_pallas.py:
// solve_polish_fused_pallas -> _solve_polish_kernel (K2),
// ruiz_admm_all_rounds_pallas -> _ruiz_admm_kernel (A/B-1), and
// polish_select_pallas_lanes / polish_select_pallas -> _polish_call ->
// _polish_kernel (A/B-2; the two TPU entries differ only in the TPU lane
// layout), with _ruiz_admm_body, _polish_body, _chol_inplace_panel,
// _tri_inverse_fsub, _gram_from_y. Plain versions: mpc/qp.py
// (solve_box_qp_batched = polish_and_select after ruiz_admm_batched),
// called through ops/admm.py.
//
// Problem: min 1/2 x'Px + q'x  s.t.  lo <= Gx <= hi, x in R^n, m rows.
//
// Design: one CTA per scenario, with its working set in shared memory.
// Past one CTA's shared memory, a cluster of CTAs a scenario, every rank
// computing its rows of K2's and A/B-1's ADMM phase ("the cluster
// variants" below).
// K2 holds P, G, the scaled Ps/Gs, Gs'Gs, M/L, L^-1, M^-1 and the polish's
// Schur matrix S (~97 KB at n = 40, m = 79, so two CTAs per SM); A/B-1
// leaves out S and the polish vectors (~69 KB), A/B-2 everything scaled
// (~76 KB). Each CTA runs its own check loop and leaves it when its
// scenario converges or stalls. The TPU kernel iterates a group of 128
// scenarios until all have converged, but frozen scenarios do not move and
// a group refactorization recomputes the same factor for them, so
// per-scenario exit is the same algorithm. The second polish attempt
// likewise runs only where its scenario needs it. The two-launch pipeline
// (A/B-1, then A/B-2) runs the same device code as K2 and hands x, y and
// the primal residual over as float32 through device memory, so its
// results are K2's bit for bit.
//
// The polish builds, factors and solves its Schur system on the active
// rows only. The TPU kernel factors the full masked m x m matrix
// S = D Vt Vt' D + (I - D), Vt = G chol(P)^-T, because its lanes need
// static shapes; the inactive rows of S are identity rows that only force
// their multipliers to zero. Here each attempt lists its a active rows in
// ascending order (a block prefix sum), forms Vt and S_aa on those rows,
// factors S_aa with the ridge of the full S (1e-7 max(max diag, 1)) and
// solves with vectors over the a rows; y is scattered back with exact zeros
// elsewhere. In ascending order chol(S_aa) is the active part of the full
// factor, so this is the same function: at the headline size (T = 20,
// m = 79) an accepted polish has a ~ 7 (p90 ~ 22), and the Schur block's
// Cholesky and the two triangular chains of each KKT solve run a columns
// and a steps, not 79. a = 0 gives the unconstrained x = -P^-1 q, y = 0.
//
// The ADMM iteration exists once (``admm_iterate``): K2 and A/B-1 run it on
// the scaled problem, the probes on the problem as given, through an
// ``Admm`` view of the operands; so do the residual check
// (``admm_residuals``) and the OSQP rho rule (``rho_rule``). M^-1 is read by
// rows; K2's is symmetric with the same float in both halves, so that is its
// column read bit for bit.
//
// The ADMM iteration's placement: each dot product of the iteration takes a
// quad of four lanes, lane c summing the residue class k = c (mod 4) of
// dot()'s four partial sums in dot()'s order, lane 0 its tail, and two xor
// shuffles add the partial sums as dot() does; with every product-add the
// same fused multiply-add, each result is dot()'s bit for bit (see "the
// quad placement" below). The matrices sit in register tiles from the start
// of each check block: G' by rows (G by columns) with lane 0's tail, M^-1
// by rows and G by rows, a row a quad; G's rows past the 64 quads sit in
// the M^-1 registers of the quads past n, which hold no row of M^-1. So an
// FMA reads only its vector entry from shared memory, a broadcast that
// serves the warp's eight quads, and all 8 warps take part in every phase.
// The scalar updates are spelled out with __fmaf_rn / __fmul_rn / __fadd_rn
// as nvcc contracted them, so that moving a load cannot move a rounding:
// the relaxation of x happens where x is next read (the start of the next
// iteration), and each z row's operands and y / rho are read before its
// sum. The tiles are sized per horizon bucket (a template on the largest n
// and m): T <= 13 with A/B-1 and the probes at four CTAs per SM (64
// registers) and K2 at three, the rest at three and two; whole rows up to
// T = 20; a larger problem reads what does not fit from shared memory in
// the same order. Around the iteration, in the same arithmetic order:
// Ruiz's maxima on quads (exact, so in any order); the Cholesky of the
// ADMM matrix with two barriers a column and a warp a row of its trailing
// update (``chol_steps``); its inverse a thread a column with no barrier a
// row (``tri_inverse_cols``). The Gram matrices G'G and Y'Y, the residual
// check, the scaled problem, the z start and the polish keep one thread
// per entry (``dot``): a quad per entry was measured slower for the short,
// already parallel sums of the Gram matrices and the once-a-block
// residuals.
//
// What bounds it on an H100: not bytes (each scenario reads ~19 KB once;
// A/B-2 reads P and G a second time), nor the SM's issue slots or
// shared-memory wavefronts (~280 a CTA-iteration at n = 40, m = 79, from
// ~800): one CTA alone on an SM takes about as long an iteration as three
// together. Each of an iteration's three phases is a latency chain (vector
// loads, ~20 dependent FMAs, two shuffles, the store, the barrier), so
// only shorter chains or more CTAs per SM would go faster; shared memory
// holds A/B-1 at three and K2 at two at T = 20. The factorization walks n
// column steps of two barriers each and a column chain of n^2 / 2 FMAs.
// All matrices have an odd leading dimension, so row and column walks are
// free of bank conflicts at any n (odd n included). Later work: several
// scenarios per CTA (T = 13), the factorization by panels in the same
// order, P's side of the polish and a warp path for a <= 32.
//
// Numerics follow the TPU kernel: Cholesky pivots are clamped with
// sqrt(max(d, 1e-30)), the polish's S gets a 1e-7 * max(diag S, 1) ridge,
// and max/clip propagate NaN as jnp.max / jnp.clip do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K2_THREADS = 256;
constexpr int NWARPS = K2_THREADS / 32;
constexpr int MAX_RED = 4;  // values reduced together

struct K2Params {
  int n, m, ruiz_iters, max_checks, check_iters;
  float sigma, alpha, eps, band, stall_cap, stall_ratio, stall_prim_cap, act_tol_rel;
};

__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clip(float v, float l, float h) { return nmin(nmax(v, l), h); }

// NaN-propagating max / plain sum over the block of K values per thread;
// every thread gets the results.
template <int K, bool MAX>
__device__ void block_reduce(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = MAX ? nmax(v[k], o) : v[k] + o;
    }
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = red[k];
    for (int w = 1; w < NWARPS; ++w) r = MAX ? nmax(r, red[w * K + k]) : r + red[w * K + k];
    v[k] = r;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum_k a[k * sa] * b[k * sb], with four partial sums to break the FMA chain
__device__ __forceinline__ float dot(const float* a, int sa, const float* b, int sb, int len) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < len; k += 4) {
    s0 += a[k * sa] * b[k * sb];
    s1 += a[(k + 1) * sa] * b[(k + 1) * sb];
    s2 += a[(k + 2) * sa] * b[(k + 2) * sb];
    s3 += a[(k + 3) * sa] * b[(k + 3) * sb];
  }
  for (; k < len; ++k) s0 += a[k * sa] * b[k * sb];
  return (s0 + s1) + (s2 + s3);
}

// sum_k a[k * sa] * v[k] for a contiguous v
__device__ __forceinline__ float dot(const float* a, int sa, const float* v, int len) {
  return dot(a, sa, v, 1, len);
}

// ---- the quad placement of the ADMM phase's dot products ----
//
// dot() sums k = 0, 1, 2, 3 (mod 4) into s0..s3 in ascending k, adds the
// len mod 4 tail into s0 and returns (s0 + s1) + (s2 + s3). The ADMM phase
// gives each output entry a quad (four neighbouring lanes): lane c sums the
// class k = c + 4j, j < len / 4, in ascending j, lane 0 then adds the tail,
// and two xor shuffles give every lane of the quad (s0 + s1) + (s2 + s3).
// With every product-add the same fused multiply-add (``fmaf``; nvcc
// contracts dot()'s ``s += a * b`` into one), that is dot()'s value bit for
// bit. The iteration's matrices sit in register tiles: quad q holds row q of
// a matrix, lane c the entries c + 4j of that row for j < min(SJ, len / 4)
// (and lane 0 the tail of G''s rows); rows q + NQUADS s past the tiles, and
// entries past them, are read from shared memory in the same order.
constexpr int NQUADS = K2_THREADS / 4;

__host__ __device__ inline int tile_row(int quad, int slot) { return quad + NQUADS * slot; }
__host__ __device__ inline int tile_entry(int cls, int j) { return cls + 4 * j; }
// register entries a lane holds of a row of length len in a tile of SJ
__host__ __device__ inline int tile_len(int SJ, int len) { return len / 4 < SJ ? len / 4 : SJ; }

// Lane cls's entries tile_entry(cls, j) of row r of the R x len matrix A
// (A[r * srow + k * sent]) into its register tile; zero past min(SJ,
// len / 4) or for r >= R. (Ptr: a pointer, or in the tests an accessor
// that counts the reads.)
template <int SJ, class Ptr>
__host__ __device__ inline void load_row(float (&t)[SJ], Ptr A, int srow, int sent, int r, int R,
                                         int len, int cls) {
  const int nj = tile_len(SJ, len);
#pragma unroll
  for (int j = 0; j < SJ; ++j)
    t[j] = (r < R && j < nj) ? A[r * srow + tile_entry(cls, j) * sent] : 0.f;
}

// Lane 0's tail k = 4 (len / 4) .. len - 1 of row r of A, as load_row lays
// a row out; zero in the other lanes.
template <class Ptr>
__host__ __device__ inline void load_tail(float (&t)[3], Ptr A, int srow, int sent, int r, int R,
                                          int len, int cls) {
  const int k0 = len / 4 * 4;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    t[k] = (cls == 0 && r < R && k0 + k < len) ? A[r * srow + (k0 + k) * sent] : 0.f;
}

// Lane cls's partial sum of a[k * sa] v[k * sv], k < len, from class entry
// j0 on, continuing s: the class's entries from shared memory, then (lane
// 0) the tail, from shared memory or from the registers of load_tail.
template <class Ptr>
__host__ __device__ inline float lane_rest(float s, int j0, Ptr a, int sa, const float* v, int sv,
                                           int cls, int len, const float* tail = nullptr) {
  const int q = len / 4;
  for (int j = j0; j < q; ++j) {
    const int k = tile_entry(cls, j);
    s = fmaf(a[k * sa], v[k * sv], s);
  }
  if (cls == 0) {
    if (tail != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (4 * q + k < len) s = fmaf(tail[k], v[(4 * q + k) * sv], s);
    } else {
      for (int k = 4 * q; k < len; ++k) s = fmaf(a[k * sa], v[k * sv], s);
    }
  }
  return s;
}

// Lane cls's partial sum with the row's first nreg class entries from the
// register tile row `reg`.
template <int SJ, class Ptr>
__host__ __device__ inline float lane_sum(const float (&reg)[SJ], int nreg, Ptr a, int sa,
                                          const float* v, int sv, int cls, int len,
                                          const float* tail = nullptr) {
  float s = 0.f;
  if (nreg == SJ) {  // the whole tile (the bucket's own horizon): no guards
#pragma unroll
    for (int j = 0; j < SJ; ++j) s = fmaf(reg[j], v[tile_entry(cls, j) * sv], s);
  } else {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      if (j < nreg) s = fmaf(reg[j], v[tile_entry(cls, j) * sv], s);
  }
  return lane_rest(s, nreg, a, sa, v, sv, cls, len, tail);
}

template <class Ptr>
__host__ __device__ inline float lane_sum(Ptr a, int sa, const float* v, int sv, int cls, int len) {
  return lane_rest(0.f, 0, a, sa, v, sv, cls, len);
}

// G's rows past the first NQUADS: when they fit the quads past n (whose
// M^-1 tile holds no row), row NQUADS + (quad - n) of G sits in quad's M^-1
// tile registers; otherwise they are read from shared memory.
__host__ __device__ inline bool extra_in_mi(int n, int m) { return m - NQUADS <= NQUADS - n; }
__host__ __device__ inline int extra_row(int quad, int n) { return NQUADS + quad - n; }

// Lane cls's class sums of G row w0 (tile g) and, where has_e, of G row w1
// (tile e) against v, the two rows sharing each load of v; zero for w0 >= m.
template <int SJ, class Ptr>
__host__ __device__ inline void g_rows(float& d0, float& d1, const float (&g)[SJ],
                                       const float (&e)[SJ], bool has_e, int nreg, Ptr G, int ld,
                                       int w0, int w1, int m, const float* v, int cls, int n) {
  d0 = 0.f;
  d1 = 0.f;
  if (nreg == SJ) {
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const float x = v[tile_entry(cls, j)];
      d0 = fmaf(g[j], x, d0);
      if (has_e) d1 = fmaf(e[j], x, d1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      if (j < nreg) {
        const float x = v[tile_entry(cls, j)];
        d0 = fmaf(g[j], x, d0);
        if (has_e) d1 = fmaf(e[j], x, d1);
      }
  }
  d0 = w0 < m ? lane_rest(d0, nreg, G + w0 * ld, 1, v, 1, cls, n) : 0.f;
  if (has_e) d1 = lane_rest(d1, nreg, G + w1 * ld, 1, v, 1, cls, n);
}

// (s0 + s1) + (s2 + s3) over the quad's lanes, in every lane of it; all 32
// lanes of the warp take part.
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = nmax(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return nmax(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// out = G'G, lower triangle, for the m x n matrix G: one thread per entry
// walks two columns of G. (A quad per entry, as the iteration sums, was
// measured slower here: the sums are short and already 256 at a time.)
__device__ void gram_cols(const float* G, float* out, int n, int m, int ld) {
  for (int e = threadIdx.x; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) out[i * ld + j] = dot(G + i, ld, G + j, ld, m);
  }
  __syncthreads();
}

// In-place lower Cholesky of the N x N matrix A (leading dimension ld; only
// the lower triangle is read or written), column by column with two barriers
// a column (thread 0 writes the pivot once every thread has read it) and the
// trailing update a warp a row, a lane a column; each entry's divisions and
// fused multiply-adds in ascending column order. The ADMM matrix's factor,
// and on one CTA the polish's (P, and the Schur block S_aa).
__device__ void chol_steps(float* A, int N, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < N; ++j) {
    const float ljj = sqrtf(nmax(A[j * ld + j], 1e-30f));
    for (int i = j + 1 + threadIdx.x; i < N; i += K2_THREADS) A[i * ld + j] /= ljj;
    __syncthreads();
    if (threadIdx.x == 0) A[j * ld + j] = ljj;
    for (int i = j + 1 + warp; i < N; i += NWARPS) {
      const float lij = A[i * ld + j];
      for (int c = j + 1 + lane; c <= i; c += 32) A[i * ld + c] -= lij * A[c * ld + j];
    }
    __syncthreads();
  }
}

// Y = L^-1 (lower) by forward substitution, a thread a column with no
// barrier a row (an entry reads only its own column's earlier rows, which the
// same thread wrote): Y[r][c] = ([r == c] - sum_{k=c}^{r-1} L[r][k] Y[k][c]) /
// L[r][r], the sum in ascending k.
__device__ void tri_inverse_cols(const float* L, float* Y, int N, int ld) {
  for (int c = threadIdx.x; c < N; c += K2_THREADS)
    for (int r = c; r < N; ++r) {
      float s = (c == r) ? 1.f : 0.f;
      for (int k = c; k < r; ++k) s -= L[r * ld + k] * Y[k * ld + c];
      Y[r * ld + c] = s / L[r * ld + r];
    }
  __syncthreads();
}

// out = Y'Y (full, symmetric) for lower-triangular Y, one thread per entry.
__device__ void gram_lower(const float* Y, float* out, int N, int ld) {
  for (int e = threadIdx.x; e < N * N; e += K2_THREADS) {
    const int i = e / N, j = e - i * N;
    if (j > i) continue;
    const float s = dot(Y + i * ld + i, ld, Y + i * ld + j, ld, N - i);
    out[i * ld + j] = s;
    out[j * ld + i] = s;
  }
  __syncthreads();
}

// Row k of a matrix whose rows sit at `base` with leading dimension ld (for
// the polish's Schur factor: one CTA's S, or an attempt's rows on a
// cluster, ``Spread``/``Global`` there).
struct Local {
  float* base;
  int ld;
  __device__ float* operator()(int k) const { return base + k * ld; }
};

// chol_steps's steps and arithmetic on the rows of an accessor (the
// polish's factors on a cluster), the trailing update a warp a row, four of
// a warp's rows at a time: the four rows' operands are loaded before any of
// their stores, one round trip where chol_steps takes one a row. Each
// entry's updates are chol_steps's, in ascending column order.
template <class Rows>
__device__ void chol_rows(Rows A, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < N; ++j) {
    float* aj = A(j);
    const float ljj = sqrtf(nmax(aj[j], 1e-30f));
    for (int i = j + 1 + threadIdx.x; i < N; i += K2_THREADS) A(i)[j] /= ljj;
    __syncthreads();
    if (threadIdx.x == 0) aj[j] = ljj;
    for (int i0 = j + 1 + warp; i0 < N; i0 += 4 * NWARPS) {
      float* row[4];
      float lij[4];
      int last[4];  // the row's last column, -1 past N
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = i0 + t * NWARPS;
        last[t] = i < N ? i : -1;
        row[t] = A(i < N ? i : i0);
        lij[t] = row[t][j];
      }
      int top = i0;  // the group's last row
#pragma unroll
      for (int t = 1; t < 4; ++t) top = last[t] >= 0 ? last[t] : top;
      for (int c = j + 1 + lane; c <= top; c += 32) {
        const float lcj = A(c)[j];
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = c <= last[t] ? row[t][c] : 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (c <= last[t]) row[t][c] = v[t] - lij[t] * lcj;
      }
    }
    __syncthreads();
  }
}

// Solve (L L') out = b for one right-hand side, L's rows through an
// accessor; warp 0 walks the two triangular chains, the lanes split each dot
// product.
template <class Rows>
__device__ void chol_solve_rows(Rows L, int N, const float* b, float* w, float* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int j = 0; j < N; ++j) {
      const float* lj = L(j);
      float s = 0.f;
      for (int k = lane; k < j; k += 32) s += lj[k] * w[k];
      s = warp_sum(s);
      if (lane == 0) w[j] = (b[j] - s) / lj[j];
      __syncwarp();
    }
    for (int j = N - 1; j >= 0; --j) {
      float s = 0.f;
      for (int k = j + 1 + lane; k < N; k += 32) s += L(k)[j] * out[k];
      s = warp_sum(s);
      if (lane == 0) out[j] = (w[j] - s) / L(j)[j];
      __syncwarp();
    }
  }
  __syncthreads();
}

// Shared-memory working set of one scenario. A kernel carves out only the
// parts its phases use (``carve``); the others stay null.
struct Work {
  int n, m, ldn, ldm;
  float *P, *G, *Ps, *Gs, *GtG, *M, *Y, *Mi, *S;
  // n-vectors
  float *q, *d, *qs, *x, *xt, *rhs, *tn, *xp1, *xp2, *u, *pir, *dx, *r1, *gv;
  // m-vectors
  float *lo, *hi, *e, *los, *his, *z, *y, *t, *Gx, *yp1, *yp2, *dm, *bv, *w, *dl, *w2, *lam, *r2;
  int* idx;  // the polish attempt's active rows, ascending
  float* red;
};

// The phases a kernel runs: K2 both, A/B-1 the ADMM, A/B-2 the polish.
enum Phases { kAdmm = 1, kPolish = 2, kBoth = 3 };

// Lay the working set of `phases` out from `base` (a null base only
// counts) and return its size in floats. The polish reuses the ADMM's M
// for chol(P), Y for its inverse and Gs for the active rows of Vt = G Y'.
// Odd leading dimensions keep row and column walks free of bank conflicts.
__host__ __device__ size_t carve(Work& s, float* base, int n, int m, int phases) {
  const bool admm = (phases & kAdmm) != 0, pol = (phases & kPolish) != 0;
  s.n = n;
  s.m = m;
  s.ldn = n | 1;
  s.ldm = m | 1;
  size_t off = 0;
  auto take = [&](bool used, size_t count) -> float* {
    if (!used) return nullptr;
    // both arms derived from base: the compiler keeps shared-memory loads
    // and stores (a null arm would make every access a generic one)
    float* ptr = base ? base + off : base;
    off += count;
    return ptr;
  };
  const size_t nn = (size_t)n * s.ldn, mn = (size_t)m * s.ldn;
  s.P = take(true, nn);
  s.G = take(true, mn);
  s.Ps = take(admm, nn);
  s.Gs = take(true, mn);
  s.GtG = take(admm, nn);
  s.M = take(true, nn);
  s.Y = take(true, nn);
  s.Mi = take(admm, nn);
  s.S = take(pol, (size_t)m * s.ldm);
  s.q = take(true, n);
  s.d = take(admm, n);
  s.qs = take(admm, n);
  s.x = take(true, n);
  s.xt = take(admm, n);
  s.rhs = take(admm, n);
  s.tn = take(admm, n);
  float** pvec[] = {&s.xp1, &s.xp2, &s.u, &s.pir, &s.dx, &s.r1, &s.gv};
  for (float** v : pvec) *v = take(pol, n);
  s.lo = take(true, m);
  s.hi = take(true, m);
  float** amvec[] = {&s.e, &s.los, &s.his, &s.z};
  for (float** v : amvec) *v = take(admm, m);
  s.y = take(true, m);
  s.t = take(admm, m);
  float** pmvec[] = {&s.Gx, &s.yp1, &s.yp2, &s.dm, &s.bv, &s.w, &s.dl, &s.w2, &s.lam, &s.r2};
  for (float** v : pmvec) *v = take(pol, m);
  s.idx = reinterpret_cast<int*>(take(pol, m));
  s.red = take(true, NWARPS * MAX_RED);
  return off;
}

size_t smem_bytes(int n, int m, int phases) {
  Work s;
  return carve(s, nullptr, n, m, phases) * sizeof(float);
}

// ---- the cluster layouts ----
//
// A working set past one CTA's shared memory is spread over a thread-block
// cluster of C CTAs (ranks). Two layouts:
//
// ``carve_split`` (K2's and A/B-1's ADMM phase, which every rank computes,
// split by rows): rank r owns the contiguous block [n0, n1) of the n rows
// and [m0, m1) of the m rows (``rank_rows``) and holds, at the same offsets
// on every rank, P (then Ps) and G' (G's columns) on its n rows, G (then
// Gs) on its m rows, G'G and M^-1 on its n rows, the whole ADMM matrix M
// (its factor L below the diagonal, Y = L^-1 above it once inverted; until
// the first factorization also the staging area of another rank's rows of
// G', so at least ceil(n / C) (m | 1) floats), the n- and m-vectors whole
// (an m-vector's entries valid on the rank's rows, and everywhere where it
// is exchanged) and the exchange slots of the cross-rank maxima.
//
// ``carve_polish`` (A/B-2, and K2's polish after its split ADMM phase, laid
// over the dead ADMM layout; every rank computes, see "the polish on a
// cluster" below): rank r holds, at the same offsets on every rank, P and G
// on its rows, the factor of P whole, the n- and m-vectors whole, the
// exchange slots and, in the rest of its shared memory, the arena of an
// attempt's active rows.
constexpr int MAX_RANKS = 4;
constexpr size_t RANK_BYTES = 232448;  // shared memory one CTA can have on an H100

// Rank r's block [lo, hi) of `count` rows split over C ranks: ceil(count /
// C) rows a rank, the last rank the rest.
struct RankRows {
  int lo, hi;
};

__host__ __device__ inline int rows_per_rank(int count, int C) { return (count + C - 1) / C; }

__host__ __device__ inline RankRows rank_rows(int count, int C, int r) {
  const int per = rows_per_rank(count, C), lo = r * per < count ? r * per : count;
  return {lo, lo + per < count ? lo + per : count};
}

// The rank that owns row i of `count` rows over C ranks.
__host__ __device__ inline int row_rank(int i, int count, int C) {
  return i / rows_per_rank(count, C);
}

// The split ADMM phase's working set on one rank (``carve_split``); the
// slabs (P, G, GT, GtG, Mi) hold the rank's rows, row i at (i - n0) (or
// r - m0).
struct SplitWork {
  int n, m, ldn, ldt, C, rank, n0, n1, m0, m1;
  float *P, *G, *GT, *GtG, *M, *Mi;
  // n-vectors
  float *q, *d, *qs, *x, *xt, *rhs, *tn, *ydiag;
  // m-vectors
  float *lo, *hi, *e, *los, *his, *z, *y, *t;
  float *xchg, *red;
};

// The floats of one rank's exchange slot: an n-entry of each of Ruiz's two
// maxima, and at least the residual check's six.
__host__ __device__ inline int xchg_len(int n) { return 2 * n > 6 ? 2 * n : 6; }

// Lay rank `rank`'s part of the split ADMM phase's working set out from
// `base` (a null base only counts) and return its size in floats, the same
// on every rank. M also stages another rank's rows of G' (``gram_split``),
// so it takes the larger of n (n | 1) and ceil(n / C) (m | 1) floats. The
// exchange slots: two sets (used in turn) of C slots of ``xchg_len`` floats,
// one a rank. Odd leading dimensions (n | 1 for rows of n, m | 1 for G's
// columns) keep row walks free of bank conflicts.
__host__ __device__ size_t carve_split(SplitWork& s, float* base, int n, int m, int C, int rank) {
  s.n = n;
  s.m = m;
  s.ldn = n | 1;
  s.ldt = m | 1;
  s.C = C;
  s.rank = rank;
  const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
  s.n0 = rn.lo;
  s.n1 = rn.hi;
  s.m0 = rm.lo;
  s.m1 = rm.hi;
  size_t off = 0;
  auto take = [&](size_t count) -> float* {
    // derived from base: the compiler keeps shared-memory loads and stores
    float* ptr = base ? base + off : base;
    off += count;
    return ptr;
  };
  const size_t pn = rows_per_rank(n, C), pm = rows_per_rank(m, C);
  s.P = take(pn * s.ldn);
  s.G = take(pm * s.ldn);
  s.GT = take(pn * s.ldt);
  s.GtG = take(pn * s.ldn);
  const size_t nn = (size_t)n * s.ldn, staged = pn * s.ldt;
  s.M = take(nn > staged ? nn : staged);
  s.Mi = take(pn * s.ldn);
  float** nvec[] = {&s.q, &s.d, &s.qs, &s.x, &s.xt, &s.rhs, &s.tn, &s.ydiag};
  for (float** v : nvec) *v = take(n);
  float** mvec[] = {&s.lo, &s.hi, &s.e, &s.los, &s.his, &s.z, &s.y, &s.t};
  for (float** v : mvec) *v = take(m);
  s.xchg = take((size_t)2 * C * xchg_len(n));
  s.red = take(NWARPS * MAX_RED);
  return off;
}

// The polish's working set on one rank of a cluster (``carve_polish``): P
// and G on the rank's rows (row i at (i - n0) ldn, row r at (r - m0) ldn);
// M, P's factor L below the diagonal and Y = L^-1 transposed above it and on
// it (``tri_inverse_upper``); the n- and m-vectors whole (pxo, px: P times
// a vector, from the rows' owners); idx; the exchange slots of the
// cross-rank maxima and flags; and the arena, where an attempt keeps its
// active rows of G and of Vt and its Schur block S_aa (``polish_attempt_c``).
struct PolishWork {
  int n, m, ldn, C, rank, n0, n1, m0, m1;
  float *P, *G, *M;
  // n-vectors
  float *q, *x, *xp1, *xp2, *u, *pir, *dx, *r1, *gv, *px, *pxo, *ydiag;
  // m-vectors
  float *lo, *hi, *y, *Gx, *yp1, *yp2, *dm, *bv, *w, *dl, *w2, *lam, *r2;
  int* idx;
  float *xchg, *red, *arena;
  size_t arena_len;
};

// The arena an attempt with `a` active rows takes where every rank keeps
// them whole (G_a, Vt_a, S_aa), and where they are spread over the ranks by
// rows at the largest a = m (Vt_a and S_aa only; G_a is read from device
// memory), in floats.
__host__ __device__ inline size_t whole_floats(int n, int a) {
  return 2 * (size_t)a * (n | 1) + (size_t)a * (a | 1);
}
__host__ __device__ inline size_t spread_floats(int n, int m, int C) {
  return (size_t)rows_per_rank(m, C) * ((n | 1) + (m | 1));
}

// Lay rank `rank`'s part of the polish's working set out from `base` (a null
// base only counts), the arena taking the rest of the rank's RANK_BYTES, and
// return the floats before the arena, the same on every rank.
__host__ __device__ size_t carve_polish(PolishWork& s, float* base, int n, int m, int C,
                                        int rank) {
  s.n = n;
  s.m = m;
  s.ldn = n | 1;
  s.C = C;
  s.rank = rank;
  const RankRows rn = rank_rows(n, C, rank), rm = rank_rows(m, C, rank);
  s.n0 = rn.lo;
  s.n1 = rn.hi;
  s.m0 = rm.lo;
  s.m1 = rm.hi;
  size_t off = 0;
  auto take = [&](size_t count) -> float* {
    // derived from base: the compiler keeps shared-memory loads and stores
    float* ptr = base ? base + off : base;
    off += count;
    return ptr;
  };
  s.P = take((size_t)rows_per_rank(n, C) * s.ldn);
  s.G = take((size_t)rows_per_rank(m, C) * s.ldn);
  s.M = take((size_t)n * s.ldn);
  float** nvec[] = {&s.q,  &s.x,  &s.xp1, &s.xp2, &s.u,   &s.pir,
                    &s.dx, &s.r1, &s.gv,  &s.px,  &s.pxo, &s.ydiag};
  for (float** v : nvec) *v = take(n);
  float** mvec[] = {&s.lo, &s.hi, &s.y, &s.Gx, &s.yp1, &s.yp2, &s.dm,
                    &s.bv, &s.w,  &s.dl, &s.w2, &s.lam, &s.r2};
  for (float** v : mvec) *v = take(m);
  s.idx = reinterpret_cast<int*>(take(m));
  s.xchg = take(2 * MAX_RANKS);
  s.red = take(NWARPS * MAX_RED);
  const size_t cap = RANK_BYTES / sizeof(float), fixed = off;
  s.arena = take(0);
  s.arena_len = cap > fixed ? cap - fixed : 0;
  return fixed;
}

// The polish layout fits C ranks: its arena holds the active rows spread at
// a = m.
__host__ __device__ inline bool polish_fits(int n, int m, int C) {
  PolishWork s;
  return carve_polish(s, nullptr, n, m, C, 0) + spread_floats(n, m, C) <=
         RANK_BYTES / sizeof(float);
}

// Shared memory of each CTA of a cluster of C at this (n, m), in floats: the
// split ADMM layout's (A/B-1), the whole rank where the polish layout fits
// (A/B-2, and K2, whose two layouts overlay each other); 0 where a layout
// does not fit.
size_t cluster_rank_floats(int n, int m, int phases, int C) {
  if (C < 2 || C > MAX_RANKS) return 0;
  const size_t cap = RANK_BYTES / sizeof(float);
  size_t most = 0;
  if (phases & kAdmm) {
    SplitWork w;
    most = carve_split(w, nullptr, n, m, C, 0);
    if (most > cap) return 0;
  }
  if (phases & kPolish) {
    // K2 hands x and y from its ADMM layout to the polish's in registers
    if (phases == kBoth && (n > K2_THREADS || m > 2 * K2_THREADS)) return 0;
    if (!polish_fits(n, m, C)) return 0;
    most = cap;  // the arena takes the rest of the rank
  }
  return most;
}

// The CTAs a scenario takes: 1 where one CTA holds the working set (the
// single-CTA kernels and ``carve``), else the smallest cluster of 2 ..
// MAX_RANKS whose layouts fit; 0 where none does.
int cluster_size(int n, int m, int phases) {
  if (smem_bytes(n, m, phases) <= RANK_BYTES) return 1;
  for (int C = 2; C <= MAX_RANKS; ++C)
    if (cluster_rank_floats(n, m, phases, C) > 0) return C;
  return 0;
}

// M -> L -> Y = L^-1 -> Minv = Y'Y, for M's lower triangle in M.
__device__ void factor_inverse(float* M, float* Y, float* Mi, int n, int ld) {
  chol_steps(M, n, ld);
  tri_inverse_cols(M, Y, n, ld);
  gram_lower(Y, Mi, n, ld);
}

// M = Ps + sigma I + rho Gs'Gs -> L -> Y = L^-1 -> Minv = Y'Y
__device__ void factorize(const Work& s, float rho, float sigma) {
  const int n = s.n, ld = s.ldn, lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n; i += NWARPS)
    for (int j = lane; j <= i; j += 32)
      s.M[i * ld + j] = (s.Ps[i * ld + j] + (i == j ? sigma : 0.f)) + rho * s.GtG[i * ld + j];
  __syncthreads();
  factor_inverse(s.M, s.Y, s.Mi, n, ld);
}

// out = P^-1 v = Y'(Y v) with the polish's Y = chol(P)^-1.
__device__ void apply_pinv(const Work& s, const float* v, float* out) {
  const int n = s.n, ld = s.ldn;
  for (int k = threadIdx.x; k < n; k += K2_THREADS) s.u[k] = dot(s.Y + k * ld, 1, v, k + 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += K2_THREADS)
    out[i] = dot(s.Y + i * ld + i, ld, s.u + i, n - i);
  __syncthreads();
}

// The rows r < m with dm[r] = 1, ascending, into idx (a block prefix sum of
// warp ballots, red as scratch); returns their count a, the same in all
// threads.
__device__ int active_rows_in(const float* dm, int* idx, float* red, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = reinterpret_cast<int*>(red);
  int a = 0;
  for (int r0 = 0; r0 < m; r0 += K2_THREADS) {
    const int r = r0 + threadIdx.x;
    const bool act = r < m && dm[r] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    __syncthreads();  // the scratch is free
    if (lane == 0) cnt[warp] = __popc(bal);
    __syncthreads();
    int before = a;
    for (int w = 0; w < NWARPS; ++w) {
      if (w == warp) before = a;
      a += cnt[w];
    }
    if (act) idx[before + __popc(bal & ((1u << lane) - 1u))] = r;
  }
  __syncthreads();
  return a;
}

// sum_k G[idx[k], j] v[k]: column j of G' times a vector over the a
// active rows.
__device__ __forceinline__ float gt_active(const Work& s, int a, int j, const float* v) {
  float acc = 0.f;
  for (int k = 0; k < a; ++k) acc += s.G[s.idx[k] * s.ldn + j] * v[k];
  return acc;
}

// One KKT solve on the a active rows (Schur factor of S_aa in S), with r2
// and dl compact (entry k belongs to row idx[k]):
// P dx + G_a' dl = r1 ; G_a dx = r2.
__device__ void kkt_solve(const Work& s, int a, const float* r1, const float* r2, float* dx,
                          float* dl) {
  const int n = s.n, ld = s.ldn;
  apply_pinv(s, r1, s.pir);
  for (int k = threadIdx.x; k < a; k += K2_THREADS)
    s.w[k] = dot(s.G + s.idx[k] * ld, 1, s.pir, n) - r2[k];
  __syncthreads();
  chol_solve_rows(Local{s.S, s.ldm}, a, s.w, s.w2, dl);
  for (int j = threadIdx.x; j < n; j += K2_THREADS) s.gv[j] = gt_active(s, a, j, dl);
  __syncthreads();
  apply_pinv(s, s.gv, dx);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) dx[i] = s.pir[i] - dx[i];
  __syncthreads();
}

// One polish attempt on the active set in (dm, bv): Schur factor on the
// active rows only, KKT solve, one refinement pass, accept test. Returns ok
// (same in all threads). The rows outside the set only force their
// multiplier to zero (identity rows of the full S = D Vt Vt' D + (I - D)),
// so they are left out of S, and y is zero there.
__device__ bool polish_attempt(const Work& s, float obj0, float span, float* xp, float* yp) {
  const int n = s.n, m = s.m, ld = s.ldn, ldm = s.ldm;
  const int a = active_rows_in(s.dm, s.idx, s.red, m);
  // Vt_a = G_a Y' in Gs (row k: active row idx[k]), then S_aa = Vt_a Vt_a',
  // lower triangle
  for (int e = threadIdx.x; e < a * n; e += K2_THREADS) {
    const int k = e / n, kk = e - k * n;
    s.Gs[k * ld + kk] = dot(s.Y + kk * ld, 1, s.G + s.idx[k] * ld, kk + 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < a * a; e += K2_THREADS) {
    const int i = e / a, j = e - i * a;
    if (j <= i) s.S[i * ldm + j] = dot(s.Gs + i * ld, 1, s.Gs + j * ld, n);
  }
  __syncthreads();
  // the full S's ridge: its inactive diagonal is 1
  float mx[1] = {-INFINITY};
  for (int i = threadIdx.x; i < a; i += K2_THREADS) mx[0] = nmax(mx[0], s.S[i * ldm + i]);
  block_reduce<1, true>(mx, s.red);
  const float reg = 1e-7f * nmax(mx[0], 1.f);
  for (int i = threadIdx.x; i < a; i += K2_THREADS) s.S[i * ldm + i] += reg;
  __syncthreads();
  chol_steps(s.S, a, ldm);

  for (int i = threadIdx.x; i < n; i += K2_THREADS) s.r1[i] = -s.q[i];
  for (int k = threadIdx.x; k < a; k += K2_THREADS) s.r2[k] = s.bv[s.idx[k]];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) yp[r] = 0.f;
  __syncthreads();
  kkt_solve(s, a, s.r1, s.r2, xp, s.lam);
  // one refinement pass through the same factors
  for (int i = threadIdx.x; i < n; i += K2_THREADS)
    s.r1[i] = -(s.q[i] + dot(s.P + i * ld, 1, xp, n) + gt_active(s, a, i, s.lam));
  for (int k = threadIdx.x; k < a; k += K2_THREADS) {
    const int r = s.idx[k];
    s.r2[k] = s.bv[r] - dot(s.G + r * ld, 1, xp, n);
  }
  __syncthreads();
  kkt_solve(s, a, s.r1, s.r2, s.dx, s.dl);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) xp[i] += s.dx[i];
  for (int k = threadIdx.x; k < a; k += K2_THREADS) yp[s.idx[k]] = s.lam[k] + s.dl[k];
  __syncthreads();

  float mxv[2] = {-INFINITY, 0.f};  // violation, non-finite flag
  float sum[1] = {0.f};             // objective
  for (int r = threadIdx.x; r < m; r += K2_THREADS) {
    const float gxp = dot(s.G + r * ld, 1, xp, n);
    mxv[0] = nmax(mxv[0], nmax(gxp - s.hi[r], s.lo[r] - gxp));
    if (!isfinite(yp[r])) mxv[1] = 1.f;
  }
  for (int i = threadIdx.x; i < n; i += K2_THREADS) {
    sum[0] += 0.5f * xp[i] * dot(s.P + i * ld, 1, xp, n) + s.q[i] * xp[i];
    if (!isfinite(xp[i])) mxv[1] = 1.f;
  }
  block_reduce<2, true>(mxv, s.red);
  block_reduce<1, false>(sum, s.red);
  return mxv[1] == 0.f && mxv[0] <= 1e-5f * span &&
         sum[0] <= obj0 + 1e-6f * fabsf(obj0) + 1e-6f;
}

// Load P, G, q, lo and hi of scenario b.
__device__ void load_problem(const Work& s, const float* __restrict__ Pg,
                             const float* __restrict__ Gg, const float* __restrict__ qg,
                             const float* __restrict__ log_, const float* __restrict__ hig,
                             int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  const float* Pb = Pg + (size_t)b * n * n;
  const float* Gb = Gg + (size_t)b * m * n;
  for (int e = tid; e < n * n; e += K2_THREADS) s.P[(e / n) * ld + e % n] = Pb[e];
  for (int e = tid; e < m * n; e += K2_THREADS) s.G[(e / n) * ld + e % n] = Gb[e];
  for (int i = tid; i < n; i += K2_THREADS) s.q[i] = qg[(size_t)b * n + i];
  for (int r = tid; r < m; r += K2_THREADS) {
    s.lo[r] = log_[(size_t)b * m + r];
    s.hi[r] = hig[(size_t)b * m + r];
  }
  __syncthreads();
}

// The register tiles of the ADMM iteration for n <= N_MAX, m <= M_MAX (a
// horizon bucket): G by rows (a row a quad; rows past NQUADS in the M^-1
// tiles of the quads past n, ``extra_in_mi``), G' by rows (G by columns,
// with the tail of lane 0) and M^-1 by rows (a row a quad), N_MAX / 4 or
// M_MAX / 4 entries a lane. A larger problem keeps what does not fit in
// shared memory, read in the same order. CTAS: the CTAs per SM A/B-1 and
// the probes are bounded to, which caps their registers (65536 / 256 /
// CTAS); K2 takes one CTA fewer (its polish needs the registers).
template <int N_MAX, int M_MAX, int CTAS>
struct Bucket {
  static constexpr int kN = N_MAX, kM = M_MAX, kSjN = N_MAX / 4, kSjM = M_MAX / 4;
  static constexpr int kCtas = CTAS;
};
// T <= 13 (the fleet; n = 26, 27, m = 51): four CTAs per SM, 64 registers
using BucketT13 = Bucket<27, 51, 4>;
// every larger problem, in registers up to T = 20 (n = 40, 41, m = 79):
// three CTAs per SM
using BucketT20 = Bucket<43, 79, 3>;

__host__ __device__ inline bool in_t13(int n, int m) {
  return n <= BucketT13::kN && m <= BucketT13::kM;
}

// The cluster variants' tiles (one CTA an SM, up to 255 registers): each
// rank's rows of G' (m long), M^-1 and G (n long) whole in registers, a
// phase in one pass, up to T = 40 (n = 80, 81, m = 159), or up to T = 60
// (n <= 121, m <= 239); past that, what does not fit is read from shared
// memory in the same order.
using BucketC40 = Bucket<83, 159, 1>;
using BucketC60 = Bucket<123, 239, 1>;

__host__ __device__ inline bool in_c40(int n, int m) {
  return n <= BucketC40::kN && m <= BucketC40::kM;
}

// The operands of the ADMM iteration and of its residual check: K2 and
// A/B-1 pass the scaled problem (Ps, Gs, qs, los, his), the probes the
// problem as given; M^-1 is read by rows. Bk: the register tiles.
template <class Bk>
struct Admm {
  int n, m, ld;
  const float *P, *G, *q, *lo, *hi, *Mi;
  float *x, *z, *y, *t, *rhs, *xt, *red;
};

// Row w's operands of the z and y update, read (and y / rho divided)
// before its G xt is summed, off the sum's latency.
struct ZRow {
  float z, y, lo, hi, y_rho;
};

template <class Bk>
__device__ __forceinline__ ZRow z_row(const Admm<Bk>& a, int w, float rho) {
  return {a.z[w], a.y[w], a.lo[w], a.hi[w], a.y[w] / rho};
}

// Row w's z, y and t from gxt = (G xt)_w. The roundings are spelled out as
// nvcc contracted ``alpha * gxt + (1.f - alpha) * z``, ``y + rho * (zt -
// zn)`` and ``rho * zn - yn`` in the one-thread-per-row update (the FMUL of
// (1 - alpha) z, then one FFMA each), so that the placement of the loads
// cannot move a contraction.
template <class Bk>
__device__ __forceinline__ void z_update(const Admm<Bk>& a, int w, const ZRow& r, float gxt,
                                         float rho, float alpha) {
  const float zt = __fmaf_rn(gxt, alpha, __fmul_rn(1.f - alpha, r.z));
  const float zn = clip(__fadd_rn(zt, r.y_rho), r.lo, r.hi);
  const float yn = __fmaf_rn(rho, __fsub_rn(zt, zn), r.y);
  a.z[w] = zn;
  a.y[w] = yn;
  a.t[w] = __fmaf_rn(rho, zn, -yn);
}

// x <- alpha xt + (1 - alpha) x, rounded as nvcc contracted it in the
// one-thread-per-entry update: the relaxation of the previous iteration,
// applied where x is next read (the start of the next iteration's G't
// phase, or after the last iteration).
__device__ __forceinline__ float relax_x(float xt, float x, float alpha) {
  return __fmaf_rn(xt, alpha, __fmul_rn(1.f - alpha, x));
}

// `iters` OSQP iterations on x, z, y at penalty rho: three barrier-separated
// matvec phases (G't, M^-1 rhs, G xt), a quad per output entry with its
// matrix row in registers (loaded here, once a call) and the vector read
// from shared memory; the lanes of a quad that holds two rows of G update
// one row each. The relaxation of x moves from the end of an iteration to
// the start of the next (the lane that forms rhs_i applies it to x_i), so
// the G xt phase ends with its z and y updates.
template <class Bk>
__device__ void admm_iterate(const Admm<Bk>& a, float rho, int iters, float sigma, float alpha) {
  const int n = a.n, m = a.m, ld = a.ld, tid = threadIdx.x, quad = tid >> 2, cls = tid & 3;
  float gt[Bk::kSjM], gtt[3], mi[Bk::kSjN], g[Bk::kSjN];
  load_row(gt, a.G, 1, ld, quad, n, m, cls);
  load_tail(gtt, a.G, 1, ld, quad, n, m, cls);
  load_row(mi, a.Mi, ld, 1, quad, n, n, cls);
  load_row(g, a.G, ld, 1, quad, m, n, cls);
  const bool extra = Bk::kM > NQUADS && extra_in_mi(n, m);  // no extra rows at T <= 13
  const int we = extra_row(quad, n);  // the G row a quad past n holds in its M^-1 tile
  const bool has_e = extra && quad >= n && we < m;
  if (has_e) load_row(mi, a.G, ld, 1, we, m, n, cls);
  const int ngt = tile_len(Bk::kSjM, m), nn = tile_len(Bk::kSjN, n);
  // the row this lane updates in the G xt phase: lane 0 its quad's, lane 1
  // the extra one
  const int wc = cls == 0 ? quad : we;
  const bool updates = cls == 0 ? quad < m : cls == 1 && has_e;
  for (int r = tid; r < m; r += K2_THREADS) a.t[r] = rho * a.z[r] - a.y[r];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int s = 0; tile_row(0, s) < n; ++s) {  // rhs = sigma x - q + G't
      const int i = tile_row(quad, s);
      const bool head = cls == 0 && i < n;
      float xi = 0.f, qi = 0.f;
      if (head) {
        xi = a.x[i];
        qi = a.q[i];
        if (it > 0) {
          xi = relax_x(a.xt[i], xi, alpha);
          a.x[i] = xi;
        }
      }
      float d = 0.f;
      if (i < n)
        d = s == 0 ? lane_sum(gt, ngt, a.G + i, ld, a.t, 1, cls, m, gtt)
                   : lane_sum(a.G + i, ld, a.t, 1, cls, m);
      d = quad_sum(d);
      if (head) a.rhs[i] = __fadd_rn(__fmaf_rn(xi, sigma, -qi), d);
    }
    __syncthreads();
    for (int s = 0; tile_row(0, s) < n; ++s) {  // xt = M^-1 rhs
      const int i = tile_row(quad, s);
      float d = 0.f;
      if (i < n)
        d = s == 0 ? lane_sum(mi, nn, a.Mi + i * ld, 1, a.rhs, 1, cls, n)
                   : lane_sum(a.Mi + i * ld, 1, a.rhs, 1, cls, n);
      d = quad_sum(d);
      if (cls == 0 && i < n) a.xt[i] = d;
    }
    __syncthreads();
    // G xt -> z, y, t: rows quad and (past n) we, updated by lanes 0 and 1
    ZRow zr = {};
    if (updates) zr = z_row(a, wc, rho);
    float d0, d1;
    g_rows(d0, d1, g, mi, has_e, nn, a.G, ld, quad, we, m, a.xt, cls, n);
    d0 = quad_sum(d0);
    if (extra) d1 = quad_sum(d1);
    if (updates) z_update(a, wc, zr, cls == 0 ? d0 : d1, rho, alpha);
    if (!extra)
      for (int s = 1; tile_row(0, s) < m; ++s) {  // rows past the tiles
        const int w = tile_row(quad, s);
        const float v = quad_sum(w < m ? lane_sum(a.G + w * ld, 1, a.xt, 1, cls, n) : 0.f);
        if (cls == 0 && w < m) z_update(a, w, z_row(a, w, rho), v, rho, alpha);
      }
    __syncthreads();
  }
  if (iters > 0) {
    for (int i = tid; i < n; i += K2_THREADS) a.x[i] = relax_x(a.xt[i], a.x[i], alpha);
    __syncthreads();
  }
}

struct Residuals {
  float prim, dual, sGx, sz, sPx, sq;
};

// max|Gx - z|, max|Px + q + G'y| and the scales max|Gx|, max|z|, max|Px|,
// max|q| (the same in all threads), one thread per row. (Once a check
// block; a quad per row, as the iteration sums, was measured slower here.)
template <class Bk>
__device__ Residuals admm_residuals(const Admm<Bk>& a) {
  const int n = a.n, m = a.m, ld = a.ld, tid = threadIdx.x;
  float mx[4] = {0.f, 0.f, 0.f, 0.f};  // prim, max|Gx|, max|z|, dual
  float mp[2] = {0.f, 0.f};            // max|Px|, max|q|
  for (int r = tid; r < m; r += K2_THREADS) {
    const float gx = dot(a.G + r * ld, 1, a.x, n);
    mx[0] = nmax(mx[0], fabsf(gx - a.z[r]));
    mx[1] = nmax(mx[1], fabsf(gx));
    mx[2] = nmax(mx[2], fabsf(a.z[r]));
  }
  for (int i = tid; i < n; i += K2_THREADS) {
    const float px = dot(a.P + i * ld, 1, a.x, n);
    mp[0] = nmax(mp[0], fabsf(px));
    mp[1] = nmax(mp[1], fabsf(a.q[i]));
    mx[3] = nmax(mx[3], fabsf(px + a.q[i] + dot(a.G + i, ld, a.y, m)));
  }
  block_reduce<4, true>(mx, a.red);
  block_reduce<2, true>(mp, a.red);
  return {mx[0], mx[3], mx[1], mx[2], mp[0], mp[1]};
}

struct RhoStep {
  float prim_rel, dual_rel, rho;
};

// The relative residuals of a check and the OSQP rule's next rho.
__device__ RhoStep rho_rule(const Residuals& r, float rho) {
  const float prim_rel = r.prim / nmax(nmax(r.sGx, r.sz), 1e-6f);
  const float dual_rel = r.dual / nmax(nmax(r.sPx, r.sq), 1e-6f);
  return {prim_rel, dual_rel,
          clip(rho * sqrtf((prim_rel + 1e-12f) / (dual_rel + 1e-12f)), 1e-6f, 1e6f)};
}

struct AdmmOut {
  float prim, dual, rho, checks, factorizations;
};

// Column j's maxima max_i d_i |P[i][j]| (mp) and max_r e_r |G[r][j]| (mg)
// over the quad, lane cls taking i, r = cls (mod 4); exact, so in any order.
__device__ __forceinline__ void col_maxima(const Work& s, int j, int cls, bool with_g, float& mp,
                                           float& mg) {
  const int n = s.n, m = s.m, ld = s.ldn;
  mp = 0.f;
  mg = 0.f;
  if (j < n) {
    for (int i = cls; i < n; i += 4) mp = nmax(mp, s.d[i] * fabsf(s.P[i * ld + j]));
    if (with_g)
      for (int r = cls; r < m; r += 4) mg = nmax(mg, s.e[r] * fabsf(s.G[r * ld + j]));
  }
  mp = quad_max(mp);
  if (with_g) mg = quad_max(mg);
}

// Ruiz equilibration and the warm-started adaptive ADMM of scenario b.
// Leaves the unscaled x and y in s.x and s.y (synchronized) and returns the
// ADMM's scaled primal and dual residuals, its final rho, the check blocks
// run and the ADMM matrices factorized. The maxima of the Ruiz loop take a
// quad a row or column (exact, so in any order); its one sum keeps a thread
// a column and block_reduce's order.
template <class Bk>
__device__ AdmmOut ruiz_admm(const Work& s, const K2Params& p, const float* __restrict__ xw,
                             const float* __restrict__ yw, const float* __restrict__ rho_w,
                             int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x, quad = tid >> 2, cls = tid & 3;
  for (int i = tid; i < n; i += K2_THREADS) s.d[i] = 1.f;
  for (int r = tid; r < m; r += K2_THREADS) s.e[r] = 1.f;
  __syncthreads();

  // ---- modified Ruiz equilibration + cost normalization ----
  float c = 1.f;
  for (int it = 0; it < p.ruiz_iters; ++it) {
    for (int j0 = 0; j0 < n; j0 += NQUADS) {  // column maxima of |Ps|, |Gs|
      const int j = j0 + quad;
      float mp, mg;
      col_maxima(s, j, cls, true, mp, mg);
      if (cls == 0 && j < n) s.tn[j] = nmax(c * s.d[j] * mp, s.d[j] * mg);
    }
    for (int r0 = 0; r0 < m; r0 += NQUADS) {  // row maxima of |Gs|
      const int r = r0 + quad;
      float mg = 0.f;
      if (r < m)
        for (int j = cls; j < n; j += 4) mg = nmax(mg, s.d[j] * fabsf(s.G[r * ld + j]));
      mg = quad_max(mg);
      if (cls == 0 && r < m) s.t[r] = s.e[r] * mg;
    }
    __syncthreads();
    for (int j = tid; j < n; j += K2_THREADS) s.d[j] = s.d[j] / sqrtf(nmax(s.tn[j], 1e-8f));
    for (int r = tid; r < m; r += K2_THREADS) s.e[r] = s.e[r] / sqrtf(nmax(s.t[r], 1e-8f));
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += NQUADS) {  // column maxima of |Ps| into tn
      const int j = j0 + quad;
      float mp, mg;
      col_maxima(s, j, cls, false, mp, mg);
      if (cls == 0 && j < n) s.tn[j] = mp;
    }
    __syncthreads();
    float sm1[1] = {0.f}, mx1[1] = {0.f};
    for (int j = tid; j < n; j += K2_THREADS) {
      const float mp = s.tn[j];
      sm1[0] += c * s.d[j] * mp;
      mx1[0] = nmax(mx1[0], fabsf(c * s.d[j] * s.q[j]));
    }
    block_reduce<1, false>(sm1, s.red);
    block_reduce<1, true>(mx1, s.red);
    c = c / nmax(nmax(sm1[0] / n, mx1[0]), 1e-8f);
  }

  // ---- scaled problem, warm start ----
  for (int e = tid; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    s.Ps[i * ld + j] = c * s.d[i] * s.d[j] * s.P[i * ld + j];
  }
  for (int e = tid; e < m * n; e += K2_THREADS) {
    const int r = e / n, j = e - r * n;
    s.Gs[r * ld + j] = s.e[r] * s.d[j] * s.G[r * ld + j];
  }
  for (int i = tid; i < n; i += K2_THREADS) {
    s.qs[i] = c * s.d[i] * s.q[i];
    s.x[i] = xw[(size_t)b * n + i] / s.d[i];
  }
  for (int r = tid; r < m; r += K2_THREADS) {
    s.los[r] = s.e[r] * s.lo[r];
    s.his[r] = s.e[r] * s.hi[r];
    s.y[r] = (c * yw[(size_t)b * m + r]) / s.e[r];
  }
  __syncthreads();
  for (int r = tid; r < m; r += K2_THREADS)
    s.z[r] = clip(dot(s.Gs + r * ld, 1, s.x, n), s.los[r], s.his[r]);
  gram_cols(s.Gs, s.GtG, n, m, ld);  // independent of rho; ends with a barrier

  // ---- adaptive ADMM ----
  const Admm<Bk> a = {n, m, ld, s.Ps, s.Gs, s.qs, s.los, s.his, s.Mi,
                      s.x, s.z, s.y, s.t, s.rhs, s.xt, s.red};
  const float rho_in = rho_w[b];
  float rho_f = rho_in, rho_p = rho_in, prev_score = 1e30f, prim = 0.f, dual = 0.f;
  float checks = 0.f, factorizations = 0.f;
  bool refac = true, conv = false;
  for (int k = 0; k < p.max_checks && !conv; ++k) {
    const float rho = refac ? rho_p : rho_f;
    if (refac) {
      factorize(s, rho, p.sigma);
      factorizations += 1.f;
    }
    checks += 1.f;
    admm_iterate(a, rho, p.check_iters, p.sigma, p.alpha);
    const Residuals res = admm_residuals(a);
    const RhoStep st = rho_rule(res, rho);
    prim = res.prim;
    dual = res.dual;
    rho_f = rho;
    rho_p = st.rho;
    const float score = nmax(st.prim_rel, st.dual_rel);
    if (p.eps > 0.f) {
      conv = st.prim_rel <= p.eps && st.dual_rel <= p.eps;
      if (p.stall_cap > 0.f)
        conv = conv || (score <= p.stall_cap && score > p.stall_ratio * prev_score &&
                        prim <= p.stall_prim_cap);
    }
    prev_score = score;
    if (p.band > 1.f) {
      const float ratio = st.rho / rho;
      refac = (ratio > p.band || ratio * p.band < 1.f) && !conv;
    } else {
      refac = !conv;
    }
  }

  // ---- unscale: x and y of the original problem ----
  for (int i = tid; i < n; i += K2_THREADS) s.x[i] = s.d[i] * s.x[i];
  for (int r = tid; r < m; r += K2_THREADS) s.y[r] = (s.e[r] * s.y[r]) / c;
  __syncthreads();

  return {prim, dual, rho_f, checks, factorizations};
}

// The two-attempt polish and select of scenario b on the unscaled ADMM
// solution in s.x, s.y, whose primal residual is prim; writes the returned
// x, y, the polish flag and the primal residual of the returned x.
__device__ void polish_and_select(const Work& s, const K2Params& p, float prim, int b,
                              float* __restrict__ x_out, float* __restrict__ y_out,
                              unsigned char* __restrict__ ok_out, float* __restrict__ prim_out) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;

  // ---- polish: factor P once (Lp in M, Y = Lp^-1) ----
  for (int e = tid; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) s.M[i * ld + j] = s.P[i * ld + j];
  }
  __syncthreads();
  chol_steps(s.M, n, ld);
  tri_inverse_cols(s.M, s.Y, n, ld);
  float acc[2] = {0.f, 0.f};              // x'Px, q'x
  float mh[2] = {-INFINITY, -INFINITY};   // max|hi|, max|y|
  for (int i = tid; i < n; i += K2_THREADS) {
    acc[0] += s.x[i] * dot(s.P + i * ld, 1, s.x, n);
    acc[1] += s.q[i] * s.x[i];
  }
  for (int r = tid; r < m; r += K2_THREADS) {
    s.Gx[r] = dot(s.G + r * ld, 1, s.x, n);
    mh[0] = nmax(mh[0], fabsf(s.hi[r]));
    mh[1] = nmax(mh[1], fabsf(s.y[r]));
  }
  block_reduce<2, false>(acc, s.red);
  block_reduce<2, true>(mh, s.red);
  const float obj0 = 0.5f * acc[0] + acc[1];
  const float span = nmax(mh[0], 1.f);
  const float tol = p.act_tol_rel * nmax(mh[1], 1.f);

  // attempt 1: the active set named by the ADMM duals
  for (int r = tid; r < m; r += K2_THREADS) {
    const bool alo = s.y[r] < -tol, ahi = s.y[r] > tol;
    s.dm[r] = (alo || ahi) ? 1.f : 0.f;
    s.bv[r] = alo ? s.lo[r] : s.hi[r];
  }
  __syncthreads();
  const bool ok1 = polish_attempt(s, obj0, span, s.xp1, s.yp1);

  // attempt 2: the set named by primal proximity, only where attempt 1 was
  // rejected and the two sets differ (equal sets repeat attempt 1 exactly)
  float diff[1] = {0.f};
  for (int r = tid; r < m; r += K2_THREADS) {
    const float gx = s.Gx[r], l = s.lo[r], h = s.hi[r];
    const float ptol = 1e-3f * nmax(nmax(fabsf(l), fabsf(h)), 1.f);
    const bool near_lo = (gx - l <= ptol) && (gx - l <= h - gx);
    const bool near_hi = (h - gx <= ptol) && (h - gx < gx - l);
    const bool alo = s.y[r] < -tol, ahi = s.y[r] > tol;
    if (near_lo != alo || near_hi != ahi) diff[0] = 1.f;
    s.w2[r] = near_lo ? 1.f : (near_hi ? 2.f : 0.f);  // read after the reduce
  }
  block_reduce<1, true>(diff, s.red);
  bool ok2 = false;
  if (!ok1 && diff[0] != 0.f) {
    for (int r = tid; r < m; r += K2_THREADS) {
      const float code = s.w2[r];
      s.dm[r] = code != 0.f ? 1.f : 0.f;
      s.bv[r] = code == 1.f ? s.lo[r] : s.hi[r];
    }
    __syncthreads();
    ok2 = polish_attempt(s, obj0, span, s.xp2, s.yp2);
  }

  // branchless-equivalent select and the primal residual of the returned x
  const float* xs = ok1 ? s.xp1 : (ok2 ? s.xp2 : s.x);
  const float* ys = ok1 ? s.yp1 : (ok2 ? s.yp2 : s.y);
  float vo[1] = {0.f};
  for (int r = tid; r < m; r += K2_THREADS) {
    const float gx = dot(s.G + r * ld, 1, xs, n);
    vo[0] = nmax(vo[0], nmax(nmax(gx - s.hi[r], s.lo[r] - gx), 0.f));
    y_out[(size_t)b * m + r] = ys[r];
  }
  for (int i = tid; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = xs[i];
  block_reduce<1, true>(vo, s.red);
  if (tid == 0) {
    const bool ok = ok1 || ok2;
    ok_out[b] = ok ? 1 : 0;
    prim_out[b] = ok ? vo[0] : nmax(prim, vo[0]);
  }
}

template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas - 1)
solve_polish_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                    const float* __restrict__ qg, const float* __restrict__ log_,
                    const float* __restrict__ hig, const float* __restrict__ xw,
                    const float* __restrict__ yw, const float* __restrict__ rho_w,
                    const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                    unsigned char* __restrict__ ok_out, float* __restrict__ prim_out,
                    float* __restrict__ dual_out, float* __restrict__ rho_out,
                    float* __restrict__ checks_out, float* __restrict__ factorizations_out) {
  extern __shared__ float sm[];
  Work s;
  carve(s, sm, p.n, p.m, kBoth);
  const int b = blockIdx.x;
  load_problem(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm<Bk>(s, p, xw, yw, rho_w, b);
  polish_and_select(s, p, a.prim, b, x_out, y_out, ok_out, prim_out);
  if (threadIdx.x == 0) {
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
    factorizations_out[b] = a.factorizations;
  }
}

// Three CTAs of ~69 KB fit an SM's shared memory at n = 40, m = 79, four
// of ~30 KB at n = 26, m = 51 (T = 13). The bucket's bound caps the
// registers so that they do not take a CTA that shared memory leaves room
// for: 64 at T = 13 (four CTAs), 80 at T = 20 (three).
template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas)
ruiz_admm_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                 const float* __restrict__ qg, const float* __restrict__ log_,
                 const float* __restrict__ hig, const float* __restrict__ xw,
                 const float* __restrict__ yw, const float* __restrict__ rho_w,
                 const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                 float* __restrict__ prim_out, float* __restrict__ dual_out,
                 float* __restrict__ rho_out, float* __restrict__ checks_out,
                 float* __restrict__ factorizations_out) {
  extern __shared__ float sm[];
  Work s;
  carve(s, sm, p.n, p.m, kAdmm);
  const int b = blockIdx.x, n = p.n, m = p.m;
  load_problem(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm<Bk>(s, p, xw, yw, rho_w, b);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = s.x[i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) y_out[(size_t)b * m + r] = s.y[r];
  if (threadIdx.x == 0) {
    prim_out[b] = a.prim;
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
    factorizations_out[b] = a.factorizations;
  }
}

__global__ void __launch_bounds__(K2_THREADS, 2)
polish_select_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                     const float* __restrict__ qg, const float* __restrict__ log_,
                     const float* __restrict__ hig, const float* __restrict__ xin,
                     const float* __restrict__ yin, const float* __restrict__ prim_in,
                     const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                     unsigned char* __restrict__ ok_out, float* __restrict__ prim_out) {
  extern __shared__ float sm[];
  Work s;
  carve(s, sm, p.n, p.m, kPolish);
  const int b = blockIdx.x, n = p.n, m = p.m;
  load_problem(s, Pg, Gg, qg, log_, hig, b);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) s.x[i] = xin[(size_t)b * n + i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) s.y[r] = yin[(size_t)b * m + r];
  __syncthreads();
  polish_and_select(s, p, prim_in[b], b, x_out, y_out, ok_out, prim_out);
}

// ---- the cluster variants of K2, A/B-1 and A/B-2 ----
//
// Where one scenario's working set passes one CTA's shared memory (K2 past
// T = 31, A/B-1 past 37, A/B-2 past 35) the wrapper launches these on a
// thread-block cluster of C = 2 .. 4 CTAs a scenario (the smallest whose
// layouts fit, ``cluster_size``), grid B C, scenario blockIdx.x / C.
//
// K2 and A/B-1: every rank computes the ADMM phase, split by output rows
// (``carve_split``). Rank r forms the entries of G't and of M^-1 rhs on its
// n rows and those of G xt, with their z, y and t updates, on its m rows,
// each on one quad in dot()'s order, with the rank's rows in register tiles
// (the cluster's buckets, ``BucketC40``/``BucketC60``: whole rows, a phase
// in one pass at T = 40, 48 and 60), and writes each entry of rhs, xt and t
// into every rank's copy (``put_all``, through distributed shared memory);
// one cluster barrier ends the phase, and the vectors are read from local
// shared memory. No sum is split between ranks and maxima are exact in any
// order, so the results are the single-CTA kernel's bit for bit. Around
// the iteration: Ruiz's maxima on the rank's rows, then the maximum across
// the ranks through the exchange slots (its one sum taken whole by every
// rank, in block_reduce's order); the scaled problem on the rank's rows,
// G's columns written into their owners' G'; G'G on the rank's rows, the
// other ranks' columns staged locally; the residual check on the rank's
// rows, then the maximum across the ranks, so that every rank takes the
// same rho, refactorization, convergence and stall decisions. The
// factorization: each rank forms M on its rows and writes them into every
// rank's M; every rank then factors the whole M itself (the single-CTA
// ``chol_steps``: the same floats, the same L everywhere), inverts it a
// thread a column (Y into M's upper triangle) and forms M^-1 on its own
// rows. A Cholesky split by rows would take two cluster barriers a column
// step (~850 cycles each on an H100 against ~60 for __syncthreads(),
// ``chip_smoke.py --solve-times``' barrier cycles); it is not built. After
// the ADMM, K2's polish runs on every rank over ``carve_polish``'s layout,
// laid over the dead ADMM layout.
//
// A/B-2, and K2's polish: every rank computes (``polish_and_select_cluster``,
// "the polish on a cluster" below).
//
// Every CTA starts and ends on a cluster barrier: none reads another's
// shared memory before all run, none leaves while another may still reach
// its own. These are their own instantiations, so the single-CTA kernels
// keep their code; a rank's own arrays stay derived from its base (LDS),
// other ranks' are reached through map_shared_rank (generic).
//
// What bounds it on an H100: the iteration's three exchanges between the
// ranks, each ~1,000 cycles (the writes and the cluster barrier), beside
// ~4,000 cycles of latency chains an iteration; then the factorization's
// column steps, which every rank walks. One CTA an SM (a rank's shared
// memory and registers), so 66 scenarios are in flight at C = 2 on 132
// SMs.
namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_barrier() { cg::this_cluster().sync(); }

// Every CTA lays its part of the split working set out and waits until the
// cluster runs; returns the scenario.
__device__ int split_start(SplitWork& s, float* sm, int n, int m) {
  cg::cluster_group cluster = cg::this_cluster();
  carve_split(s, sm, n, m, (int)cluster.num_blocks(), (int)cluster.block_rank());
  cluster.sync();
  return blockIdx.x / cluster.num_blocks();
}

// a[k] = v here and in every other rank's copy of a (W: SplitWork or
// PolishWork)
template <class W>
__device__ __forceinline__ void put_all(const W& s, float* a, int k, float v) {
  a[k] = v;
  for (int q = 0; q < s.C; ++q)
    if (q != s.rank) cg::this_cluster().map_shared_rank(a, (unsigned)q)[k] = v;
}

// Rank r's slot (``xchg_len`` floats) of exchange set `set` (0 or 1: consecutive
// exchanges take the two in turn, so a rank writes a set again only after
// every rank has passed the barrier that follows its reads of it).
__device__ __forceinline__ float* xchg_slot(const SplitWork& s, int set, int r) {
  return s.xchg + ((size_t)set * s.C + r) * xchg_len(s.n);
}

// Entry k's maximum over the ranks' slots of exchange set `set` (exact, so
// in any order).
__device__ __forceinline__ float xchg_max(const SplitWork& s, int set, int k) {
  float v = xchg_slot(s, set, 0)[k];
  for (int q = 1; q < s.C; ++q) v = nmax(v, xchg_slot(s, set, q)[k]);
  return v;
}

// Load scenario b's P and G on the rank's rows, q whole, lo and hi on the
// rank's rows.
__device__ void load_split(const SplitWork& s, const float* __restrict__ Pg,
                           const float* __restrict__ Gg, const float* __restrict__ qg,
                           const float* __restrict__ log_, const float* __restrict__ hig, int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  const int pn = s.n1 - s.n0, pm = s.m1 - s.m0;
  const float* Pb = Pg + (size_t)b * n * n + (size_t)s.n0 * n;
  const float* Gb = Gg + (size_t)b * m * n + (size_t)s.m0 * n;
  for (int e = tid; e < pn * n; e += K2_THREADS) s.P[(e / n) * ld + e % n] = Pb[e];
  for (int e = tid; e < pm * n; e += K2_THREADS) s.G[(e / n) * ld + e % n] = Gb[e];
  for (int i = tid; i < n; i += K2_THREADS) s.q[i] = qg[(size_t)b * n + i];
  for (int r = s.m0 + tid; r < s.m1; r += K2_THREADS) {
    s.lo[r] = log_[(size_t)b * m + r];
    s.hi[r] = hig[(size_t)b * m + r];
  }
  __syncthreads();
}

// Column j's maxima over the rank's rows, max_i d_i |P[i][j]| (mp) and
// max_r e_r |G[r][j]| (mg), lane cls taking the rows cls (mod 4) of the
// rank's; exact, so in any order.
__device__ __forceinline__ void col_maxima_split(const SplitWork& s, int j, int cls, bool with_g,
                                                 float& mp, float& mg) {
  const int n = s.n, ld = s.ldn;
  mp = 0.f;
  mg = 0.f;
  if (j < n) {
    for (int i = s.n0 + cls; i < s.n1; i += 4)
      mp = nmax(mp, s.d[i] * fabsf(s.P[(i - s.n0) * ld + j]));
    if (with_g)
      for (int r = s.m0 + cls; r < s.m1; r += 4)
        mg = nmax(mg, s.e[r] * fabsf(s.G[(r - s.m0) * ld + j]));
  }
  mp = quad_max(mp);
  if (with_g) mg = quad_max(mg);
}

// G'G on the rank's rows: entry (i, j), j <= i, a thread an entry, is
// gram_cols's dot of G's columns i and j, the rank's own row of G' and row
// j of G' staged from its owner, one rank at a time, into M (free until the
// factorization), so that every read is local. Ends with a cluster barrier
// (before any rank writes M).
__device__ void gram_split(const SplitWork& s) {
  const int n = s.n, m = s.m, ldt = s.ldt, tid = threadIdx.x, pn = s.n1 - s.n0;
  for (int q = 0; q < s.C; ++q) {
    const RankRows rq = rank_rows(n, s.C, q);
    const int qn = rq.hi - rq.lo;
    if (rq.lo >= s.n1) break;  // only j <= i
    const float* cols = s.GT;
    if (q != s.rank) {
      const float* from = cg::this_cluster().map_shared_rank(s.GT, (unsigned)q);
      for (int k = tid; k < qn * ldt; k += K2_THREADS) s.M[k] = from[k];
      __syncthreads();
      cols = s.M;
    }
    for (int e = tid; e < pn * qn; e += K2_THREADS) {
      const int li = e / qn, lj = e - li * qn, i = s.n0 + li, j = rq.lo + lj;
      if (j <= i) s.GtG[li * s.ldn + j] = dot(s.GT + li * ldt, 1, cols + lj * ldt, 1, m);
    }
    __syncthreads();
  }
  cluster_barrier();
}

// Y = L^-1 for the lower L in M, a thread a column: tri_inverse_cols's
// entries and chains, with Y's strict lower triangle transposed into M's
// upper one (Y[r][c] at M[c][r]) and its diagonal into ydiag and then, once
// every column is done, into M's diagonal: row c of M from column c on is
// then Y's column c from row c down. A column's rows go four at a time:
// their chains (each over k = c .. r - 1 in ascending k, as
// tri_inverse_cols sums it) interleaved over the k all four need, then
// finished in turn as each row's entry of Y becomes known.
__device__ void tri_inverse_upper(float* M, float* ydiag, int N, int ld) {
  for (int c = threadIdx.x; c < N; c += K2_THREADS) {
    const float ycc = 1.f / M[c * ld + c];
    ydiag[c] = ycc;
    float* yc = M + c * ld;  // Y's column c: yc[r] = Y[r][c], r > c
    for (int r0 = c + 1; r0 < N; r0 += 4) {
      const int nr = N - r0 < 4 ? N - r0 : 4;
      const float* l0 = M + r0 * ld;
      const float* l1 = l0 + ld;
      const float* l2 = l1 + ld;
      const float* l3 = l2 + ld;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      s0 -= l0[c] * ycc;
      if (nr > 1) s1 -= l1[c] * ycc;
      if (nr > 2) s2 -= l2[c] * ycc;
      if (nr > 3) s3 -= l3[c] * ycc;
      for (int k = c + 1; k < r0; ++k) {
        const float y = yc[k];
        s0 -= l0[k] * y;
        if (nr > 1) s1 -= l1[k] * y;
        if (nr > 2) s2 -= l2[k] * y;
        if (nr > 3) s3 -= l3[k] * y;
      }
      const float y0 = s0 / l0[r0];
      yc[r0] = y0;
      if (nr > 1) {
        s1 -= l1[r0] * y0;
        if (nr > 2) s2 -= l2[r0] * y0;
        if (nr > 3) s3 -= l3[r0] * y0;
        const float y1 = s1 / l1[r0 + 1];
        yc[r0 + 1] = y1;
        if (nr > 2) {
          s2 -= l2[r0 + 1] * y1;
          if (nr > 3) s3 -= l3[r0 + 1] * y1;
          const float y2 = s2 / l2[r0 + 2];
          yc[r0 + 2] = y2;
          if (nr > 3) {
            s3 -= l3[r0 + 2] * y2;
            yc[r0 + 3] = s3 / l3[r0 + 3];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += K2_THREADS) M[c * ld + c] = ydiag[c];
  __syncthreads();
}

// M^-1 = Y'Y on the rank's rows, an entry a thread: entry (i, k) is
// gram_lower's dot of Y's columns max(i, k) and min(i, k) from row max(i, k)
// down (in M's rows after ``tri_inverse_upper``), so the two halves hold the
// same float.
__device__ void gram_rows(const SplitWork& s) {
  const int n = s.n, ld = s.ldn, pn = s.n1 - s.n0;
  for (int e = threadIdx.x; e < pn * n; e += K2_THREADS) {
    const int li = e / n, k = e - li * n, i = s.n0 + li;
    const int hi = i > k ? i : k, lo = i > k ? k : i;
    s.Mi[li * ld + k] = dot(s.M + hi * ld + hi, 1, s.M + lo * ld + hi, 1, n - hi);
  }
  __syncthreads();
}

// M = Ps + sigma I + rho Gs'Gs -> L -> Y = L^-1 -> M^-1 = Y'Y (the rank's
// rows): each rank forms M on its rows into every rank's M, then every rank
// factors and inverts the whole M (the same floats, the same factor).
__device__ void factorize_split(const SplitWork& s, float rho, float sigma) {
  const int n = s.n, ld = s.ldn, lane = threadIdx.x & 31;
  for (int i = s.n0 + (threadIdx.x >> 5); i < s.n1; i += NWARPS)
    for (int j = lane; j <= i; j += 32) {
      const int li = i - s.n0;
      put_all(s, s.M, i * ld + j,
              (s.P[li * ld + j] + (i == j ? sigma : 0.f)) + rho * s.GtG[li * ld + j]);
    }
  cluster_barrier();
  chol_steps(s.M, n, ld);
  tri_inverse_upper(s.M, s.ydiag, n, ld);
  gram_rows(s);
}

// Row w's operands of the z and y update (``z_row``).
__device__ __forceinline__ ZRow z_row_split(const SplitWork& s, int w, float rho) {
  return {s.z[w], s.y[w], s.los[w], s.his[w], s.y[w] / rho};
}

// Row w's z and y here and its t on every rank, rounded as ``z_update``.
__device__ __forceinline__ void z_update_split(const SplitWork& s, int w, const ZRow& r,
                                               float gxt, float rho, float alpha) {
  const float zt = __fmaf_rn(gxt, alpha, __fmul_rn(1.f - alpha, r.z));
  const float zn = clip(__fadd_rn(zt, r.y_rho), r.lo, r.hi);
  const float yn = __fmaf_rn(rho, __fsub_rn(zt, zn), r.y);
  s.z[w] = zn;
  s.y[w] = yn;
  put_all(s, s.t, w, __fmaf_rn(rho, zn, -yn));
}

// ``admm_iterate`` split by output rows: the rank's n rows of G't and M^-1
// rhs and its m rows of G xt, a quad a row with the row in the register
// tiles of Bk (G' and M^-1 on the rank's n rows, G on its m rows, G's rows
// past NQUADS in the M^-1 tiles of the quads past the rank's n rows); each
// phase's entries written into every rank's rhs, xt or t, then a cluster
// barrier. At the end the rank's x (relaxed) and y go to every rank.
template <class Bk>
__device__ void admm_iterate_split(const SplitWork& s, float rho, int iters, float sigma,
                                   float alpha) {
  const int n = s.n, m = s.m, ld = s.ldn, ldt = s.ldt, tid = threadIdx.x, quad = tid >> 2,
            cls = tid & 3;
  const int n0 = s.n0, m0 = s.m0, pn = s.n1 - n0, pm = s.m1 - m0;
  float gt[Bk::kSjM], gtt[3], mi[Bk::kSjN], g[Bk::kSjN];
  load_row(gt, s.GT, ldt, 1, quad, pn, m, cls);
  load_tail(gtt, s.GT, ldt, 1, quad, pn, m, cls);
  load_row(mi, s.Mi, ld, 1, quad, pn, n, cls);
  load_row(g, s.G, ld, 1, quad, pm, n, cls);
  const bool extra = extra_in_mi(pn, pm);
  const int we = extra_row(quad, pn);  // the local G row a quad past pn holds in its M^-1 tile
  const bool has_e = extra && quad >= pn && we < pm;
  if (has_e) load_row(mi, s.G, ld, 1, we, pm, n, cls);
  const int ngt = tile_len(Bk::kSjM, m), nn = tile_len(Bk::kSjN, n);
  const int wc = cls == 0 ? quad : we;
  const bool updates = cls == 0 ? quad < pm : cls == 1 && has_e;
  for (int r = m0 + tid; r < s.m1; r += K2_THREADS) put_all(s, s.t, r, rho * s.z[r] - s.y[r]);
  cluster_barrier();
  for (int it = 0; it < iters; ++it) {
    for (int sl = 0; tile_row(0, sl) < pn; ++sl) {  // rhs = sigma x - q + G't
      const int li = tile_row(quad, sl), i = n0 + li;
      const bool head = cls == 0 && li < pn;
      float xi = 0.f, qi = 0.f;
      if (head) {
        xi = s.x[i];
        qi = s.qs[i];
        if (it > 0) {
          xi = relax_x(s.xt[i], xi, alpha);
          s.x[i] = xi;
        }
      }
      float d = 0.f;
      if (li < pn)
        d = sl == 0 ? lane_sum(gt, ngt, s.GT + li * ldt, 1, s.t, 1, cls, m, gtt)
                    : lane_sum(s.GT + li * ldt, 1, s.t, 1, cls, m);
      d = quad_sum(d);
      if (head) put_all(s, s.rhs, i, __fadd_rn(__fmaf_rn(xi, sigma, -qi), d));
    }
    cluster_barrier();
    for (int sl = 0; tile_row(0, sl) < pn; ++sl) {  // xt = M^-1 rhs
      const int li = tile_row(quad, sl);
      float d = 0.f;
      if (li < pn)
        d = sl == 0 ? lane_sum(mi, nn, s.Mi + li * ld, 1, s.rhs, 1, cls, n)
                    : lane_sum(s.Mi + li * ld, 1, s.rhs, 1, cls, n);
      d = quad_sum(d);
      if (cls == 0 && li < pn) put_all(s, s.xt, n0 + li, d);
    }
    cluster_barrier();
    // G xt -> z, y, t: local rows quad and (past pn) we, updated by lanes 0 and 1
    ZRow zr = {};
    if (updates) zr = z_row_split(s, m0 + wc, rho);
    float d0, d1;
    g_rows(d0, d1, g, mi, has_e, nn, s.G, ld, quad, we, pm, s.xt, cls, n);
    d0 = quad_sum(d0);
    if (extra) d1 = quad_sum(d1);
    if (updates) z_update_split(s, m0 + wc, zr, cls == 0 ? d0 : d1, rho, alpha);
    if (!extra)
      for (int sl = 1; tile_row(0, sl) < pm; ++sl) {  // rows past the tiles
        const int lw = tile_row(quad, sl);
        const float v = quad_sum(lw < pm ? lane_sum(s.G + lw * ld, 1, s.xt, 1, cls, n) : 0.f);
        if (cls == 0 && lw < pm) z_update_split(s, m0 + lw, z_row_split(s, m0 + lw, rho), v, rho,
                                                alpha);
      }
    cluster_barrier();
  }
  if (iters > 0) {
    for (int i = n0 + tid; i < s.n1; i += K2_THREADS)
      put_all(s, s.x, i, relax_x(s.xt[i], s.x[i], alpha));
    for (int r = m0 + tid; r < s.m1; r += K2_THREADS) put_all(s, s.y, r, s.y[r]);
    cluster_barrier();
  }
}

// ``admm_residuals`` on the rank's rows (a thread a row), then the maxima
// across the ranks through exchange set xs & 1 (xs counts the exchanges):
// the same numbers on every rank.
__device__ Residuals admm_residuals_split(const SplitWork& s, int& xs) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  float mx[4] = {0.f, 0.f, 0.f, 0.f};  // prim, max|Gx|, max|z|, dual
  float mp[2] = {0.f, 0.f};            // max|Px|, max|q|
  for (int r = s.m0 + tid; r < s.m1; r += K2_THREADS) {
    const float gx = dot(s.G + (r - s.m0) * ld, 1, s.x, n);
    mx[0] = nmax(mx[0], fabsf(gx - s.z[r]));
    mx[1] = nmax(mx[1], fabsf(gx));
    mx[2] = nmax(mx[2], fabsf(s.z[r]));
  }
  for (int i = s.n0 + tid; i < s.n1; i += K2_THREADS) {
    const float px = dot(s.P + (i - s.n0) * ld, 1, s.x, n);
    mp[0] = nmax(mp[0], fabsf(px));
    mp[1] = nmax(mp[1], fabsf(s.qs[i]));
    mx[3] = nmax(mx[3], fabsf(px + s.qs[i] + dot(s.GT + (i - s.n0) * s.ldt, 1, s.y, m)));
  }
  block_reduce<4, true>(mx, s.red);
  block_reduce<2, true>(mp, s.red);
  const int set = xs & 1;
  ++xs;
  if (tid < 6) put_all(s, xchg_slot(s, set, s.rank), tid, tid < 4 ? mx[tid] : mp[tid - 4]);
  cluster_barrier();
  return {xchg_max(s, set, 0), xchg_max(s, set, 3), xchg_max(s, set, 1), xchg_max(s, set, 2),
          xchg_max(s, set, 4), xchg_max(s, set, 5)};
}

// ``ruiz_admm`` split by rows over the cluster (``carve_split``): leaves the
// unscaled x whole on every rank and the unscaled y on each rank's rows and
// returns what ruiz_admm returns, the same on every rank.
template <class Bk>
__device__ AdmmOut ruiz_admm_split(const SplitWork& s, const K2Params& p,
                                   const float* __restrict__ xw, const float* __restrict__ yw,
                                   const float* __restrict__ rho_w, int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x, quad = tid >> 2, cls = tid & 3;
  const int n0 = s.n0, m0 = s.m0, m1 = s.m1;
  int xs = 0;  // exchanges so far
  for (int i = tid; i < n; i += K2_THREADS) s.d[i] = 1.f;
  for (int r = m0 + tid; r < m1; r += K2_THREADS) s.e[r] = 1.f;
  __syncthreads();

  // ---- modified Ruiz equilibration + cost normalization ----
  float c = 1.f;
  for (int it = 0; it < p.ruiz_iters; ++it) {
    float* mine = xchg_slot(s, xs & 1, s.rank);
    for (int j0 = 0; j0 < n; j0 += NQUADS) {  // column maxima of |Ps|, |Gs| on the rank's rows
      const int j = j0 + quad;
      float mp, mg;
      col_maxima_split(s, j, cls, true, mp, mg);
      if (cls == 0 && j < n) {
        put_all(s, mine, j, mp);
        put_all(s, mine, n + j, mg);
      }
    }
    for (int r0 = m0; r0 < m1; r0 += NQUADS) {  // row maxima of |Gs|
      const int r = r0 + quad;
      float mg = 0.f;
      if (r < m1)
        for (int j = cls; j < n; j += 4) mg = nmax(mg, s.d[j] * fabsf(s.G[(r - m0) * ld + j]));
      mg = quad_max(mg);
      if (cls == 0 && r < m1) s.t[r] = s.e[r] * mg;
    }
    cluster_barrier();
    for (int j = tid; j < n; j += K2_THREADS) {
      s.tn[j] = nmax(c * s.d[j] * xchg_max(s, xs & 1, j), s.d[j] * xchg_max(s, xs & 1, n + j));
      s.d[j] = s.d[j] / sqrtf(nmax(s.tn[j], 1e-8f));
    }
    for (int r = m0 + tid; r < m1; r += K2_THREADS) s.e[r] = s.e[r] / sqrtf(nmax(s.t[r], 1e-8f));
    ++xs;
    __syncthreads();
    mine = xchg_slot(s, xs & 1, s.rank);
    for (int j0 = 0; j0 < n; j0 += NQUADS) {  // column maxima of |Ps| on the rank's rows
      const int j = j0 + quad;
      float mp, mg;
      col_maxima_split(s, j, cls, false, mp, mg);
      if (cls == 0 && j < n) put_all(s, mine, j, mp);
    }
    cluster_barrier();
    for (int j = tid; j < n; j += K2_THREADS) s.tn[j] = xchg_max(s, xs & 1, j);
    ++xs;
    __syncthreads();
    float sm1[1] = {0.f}, mx1[1] = {0.f};
    for (int j = tid; j < n; j += K2_THREADS) {
      const float mp = s.tn[j];
      sm1[0] += c * s.d[j] * mp;
      mx1[0] = nmax(mx1[0], fabsf(c * s.d[j] * s.q[j]));
    }
    block_reduce<1, false>(sm1, s.red);
    block_reduce<1, true>(mx1, s.red);
    c = c / nmax(nmax(sm1[0] / n, mx1[0]), 1e-8f);
  }

  // ---- scaled problem, warm start ----
  const int pn = s.n1 - n0, pm = m1 - m0, per = rows_per_rank(n, s.C);
  for (int e = tid; e < pn * n; e += K2_THREADS) {
    const int li = e / n, j = e - li * n;
    s.P[li * ld + j] = c * s.d[n0 + li] * s.d[j] * s.P[li * ld + j];
  }
  for (int e = tid; e < pm * n; e += K2_THREADS) {
    const int lr = e / n, j = e - lr * n, r = m0 + lr, q = row_rank(j, n, s.C);
    const float v = s.e[r] * s.d[j] * s.G[lr * ld + j];
    s.G[lr * ld + j] = v;
    float* gt = s.GT + (size_t)(j - q * per) * s.ldt + r;  // G's column j: its owner's G' row
    if (q == s.rank) *gt = v;
    else *cg::this_cluster().map_shared_rank(gt, (unsigned)q) = v;
  }
  for (int i = tid; i < n; i += K2_THREADS) {
    s.qs[i] = c * s.d[i] * s.q[i];
    s.x[i] = xw[(size_t)b * n + i] / s.d[i];
  }
  for (int r = m0 + tid; r < m1; r += K2_THREADS) {
    s.los[r] = s.e[r] * s.lo[r];
    s.his[r] = s.e[r] * s.hi[r];
    s.y[r] = (c * yw[(size_t)b * m + r]) / s.e[r];
  }
  cluster_barrier();  // every rank's G' is whole
  for (int r = m0 + tid; r < m1; r += K2_THREADS)
    s.z[r] = clip(dot(s.G + (r - m0) * ld, 1, s.x, n), s.los[r], s.his[r]);
  gram_split(s);  // independent of rho; ends with a cluster barrier

  // ---- adaptive ADMM ----
  const float rho_in = rho_w[b];
  float rho_f = rho_in, rho_p = rho_in, prev_score = 1e30f, prim = 0.f, dual = 0.f;
  float checks = 0.f, factorizations = 0.f;
  bool refac = true, conv = false;
  for (int k = 0; k < p.max_checks && !conv; ++k) {
    const float rho = refac ? rho_p : rho_f;
    if (refac) {
      factorize_split(s, rho, p.sigma);
      factorizations += 1.f;
    }
    checks += 1.f;
    admm_iterate_split<Bk>(s, rho, p.check_iters, p.sigma, p.alpha);
    const Residuals res = admm_residuals_split(s, xs);
    const RhoStep st = rho_rule(res, rho);
    prim = res.prim;
    dual = res.dual;
    rho_f = rho;
    rho_p = st.rho;
    const float score = nmax(st.prim_rel, st.dual_rel);
    if (p.eps > 0.f) {
      conv = st.prim_rel <= p.eps && st.dual_rel <= p.eps;
      if (p.stall_cap > 0.f)
        conv = conv || (score <= p.stall_cap && score > p.stall_ratio * prev_score &&
                        prim <= p.stall_prim_cap);
    }
    prev_score = score;
    if (p.band > 1.f) {
      const float ratio = st.rho / rho;
      refac = (ratio > p.band || ratio * p.band < 1.f) && !conv;
    } else {
      refac = !conv;
    }
  }

  // ---- unscale: x and y of the original problem ----
  for (int i = tid; i < n; i += K2_THREADS) s.x[i] = s.d[i] * s.x[i];
  for (int r = m0 + tid; r < m1; r += K2_THREADS) s.y[r] = (s.e[r] * s.y[r]) / c;
  __syncthreads();

  return {prim, dual, rho_f, checks, factorizations};
}

// ---- the polish on a cluster ----
//
// A/B-2 past T = 35, and K2's polish after its split ADMM phase past T = 31,
// on every rank of the cluster over ``carve_polish``'s layout. Each rank
// holds P and G on its own rows, so that no dot product reads P or G
// through another rank's shared memory: the products of P and G with a
// vector (P x and G x at the start, P xp for the refinement and the
// objective, G xp for the accept test's violation, G x for the select's) are
// formed by the rows' owners, a row on a quad in dot()'s order
// (``rows_on_quads``), and written into every rank's copy (``put_all``), or
// their maxima exchanged (exact, in any order), one cluster barrier a phase.
// P's factor is formed on every rank from P's lower triangle, read from
// device memory (``chol_rows``, then ``tri_inverse_upper``: Y = L^-1 in M's
// upper triangle), and the sums reduced over threads keep block_reduce's
// order on every rank, so every rank takes the same decisions. An attempt
// lists its a active rows on every rank, then:
// - where the rank's arena holds them whole (``whole_floats``; a <= 131 at
//   T = 40 on two ranks, 103 at T = 48, 85 at T = 60 on four), every rank stages
//   G_a from device memory and forms its block of Vt_a's rows
//   (``rank_rows`` of a) into every rank's Vt_a; after one cluster barrier
//   every rank forms the whole S_aa, factors it and runs the KKT solves on
//   its own copies (the short serial chains, which a split would lengthen
//   by a cluster barrier a step);
// - past that, Vt_a and S_aa are spread over the ranks by rows (``Spread``;
//   every a up to m fits, ``polish_fits``): the owners form their rows,
//   G_a read from device memory, and rank 0 factors S_aa and solves
//   through distributed shared memory while the others wait, handing its
//   x over where the owners need it (``share``).
// Every entry is formed as on one CTA (``polish_attempt``): the same
// operands in the same order, so the results are the single-CTA kernel's
// bit for bit.

// Row k of an attempt's active rows: in the rank's own arena (``Local``), in
// its owner's arena (``Spread``, rows_per_rank(a, C) a rank), or row idx[k]
// of G in device memory (``Global``).
struct Spread {
  float* base;
  int ld, per, rank;
  __device__ float* operator()(int k) const {
    const int q = k / per;
    float* p = base + (size_t)(k - q * per) * ld;
    return q == rank ? p : cg::this_cluster().map_shared_rank(p, (unsigned)q);
  }
};

struct Global {
  const float* base;
  const int* idx;
  int ld;
  __device__ const float* operator()(int k) const { return base + (size_t)idx[k] * ld; }
};

// apply_pinv with Y = chol(P)^-1 in M's upper triangle (Y[r][c] at M[c][r]):
// row k of Y is column k of M down to the diagonal, column i of Y from row
// i on is row i of M from the diagonal on.
__device__ void apply_pinv_c(const PolishWork& s, const float* v, float* out) {
  const int n = s.n, ld = s.ldn;
  for (int k = threadIdx.x; k < n; k += K2_THREADS) s.u[k] = dot(s.M + k, ld, v, 1, k + 1);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += K2_THREADS)
    out[i] = dot(s.M + i * ld + i, 1, s.u + i, 1, n - i);
  __syncthreads();
}

// gt_active on the staged rows: sum_k G_a[k][j] v[k].
template <class Ga>
__device__ __forceinline__ float gt_active_c(Ga ga, int a, int j, const float* v) {
  float acc = 0.f;
  for (int k = 0; k < a; ++k) acc += ga(k)[j] * v[k];
  return acc;
}

// kkt_solve on the staged rows and the Schur factor in S.
template <class Ga, class Rows>
__device__ void kkt_solve_c(const PolishWork& s, int a, Ga ga, Rows S, const float* r1,
                            const float* r2, float* dx, float* dl) {
  const int n = s.n;
  apply_pinv_c(s, r1, s.pir);
  for (int k = threadIdx.x; k < a; k += K2_THREADS) s.w[k] = dot(ga(k), 1, s.pir, 1, n) - r2[k];
  __syncthreads();
  chol_solve_rows(S, a, s.w, s.w2, dl);
  for (int j = threadIdx.x; j < n; j += K2_THREADS) s.gv[j] = gt_active_c(ga, a, j, dl);
  __syncthreads();
  apply_pinv_c(s, s.gv, dx);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) dx[i] = s.pir[i] - dx[i];
  __syncthreads();
}

// f(e, A_e v) for each of the `rows` rows A_e (leading dimension ldn) on the
// rank, a row on a quad in dot()'s order (lane 0 of the quad calls f).
template <class F>
__device__ __forceinline__ void rows_on_quads(const PolishWork& s, const float* A, int rows,
                                              const float* v, F f) {
  const int quad = threadIdx.x >> 2, cls = threadIdx.x & 3;
  for (int e0 = 0; e0 < rows; e0 += NQUADS) {
    const int e = e0 + quad;
    const float d = quad_sum(e < rows ? lane_sum(A + (size_t)e * s.ldn, 1, v, 1, cls, s.n) : 0.f);
    if (cls == 0 && e < rows) f(e, d);
  }
}

// P v on the rank's rows into every rank's pv.
__device__ void p_rows(const PolishWork& s, const float* v, float* pv) {
  rows_on_quads(s, s.P, s.n1 - s.n0, v, [&](int e, float d) { put_all(s, pv, s.n0 + e, d); });
}

// The maximum of every rank's v (thread 0's) through exchange set xs & 1,
// after one cluster barrier; the same on every rank.
__device__ float cross_max(const PolishWork& s, float v, int& xs) {
  float* set = s.xchg + (xs & 1) * MAX_RANKS;
  ++xs;
  if (threadIdx.x == 0) put_all(s, set, s.rank, v);
  cluster_barrier();
  float r = set[0];
  for (int q = 1; q < s.C; ++q) r = nmax(r, set[q]);
  return r;
}

// With the active rows spread (rank 0 alone solves), rank 0's v into every
// rank's v, then a cluster barrier.
__device__ void share(const PolishWork& s, bool spread, float* v, int len) {
  if (!spread) return;
  if (s.rank == 0)
    for (int i = threadIdx.x; i < len; i += K2_THREADS)
      for (int q = 1; q < s.C; ++q) cg::this_cluster().map_shared_rank(v, (unsigned)q)[i] = v[i];
  cluster_barrier();
}

// polish_attempt on a cluster, with the active rows idx[0 .. a) listed on
// every rank, G_a, Vt_a and S_aa through the accessors ga, vt and S (whole
// on every rank, or spread: then the replicated steps run on rank 0 only).
// Returns ok, the same on every rank.
template <class Ga, class Rows>
__device__ bool polish_attempt_c(const PolishWork& s, int a, Ga ga, Rows vt, Rows S, bool spread,
                                 float obj0, float span, float* xp, float* yp, int& xs) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  const bool run = !spread || s.rank == 0;  // runs the steps every rank would repeat
  const RankRows rk = rank_rows(a, s.C, s.rank);
  // Vt_a = G_a Y' on the rank's block of the active rows, into every rank's
  // copy (spread: the owner's)
  for (int e = tid; e < (rk.hi - rk.lo) * n; e += K2_THREADS) {
    const int k = rk.lo + e / n, kk = e - (k - rk.lo) * n;
    const float v = dot(s.M + kk, ld, ga(k), 1, kk + 1);
    if (spread) vt(k)[kk] = v;
    else put_all(s, vt(k), kk, v);
  }
  cluster_barrier();
  // S_aa = Vt_a Vt_a', lower triangle: every row on every rank (spread: the
  // owner's rows)
  const int i0 = spread ? rk.lo : 0, rows = spread ? rk.hi - rk.lo : a;
  for (int e = tid; e < rows * a; e += K2_THREADS) {
    const int i = i0 + e / a, j = e - (i - i0) * a;
    if (j <= i) S(i)[j] = dot(vt(i), 1, vt(j), 1, n);
  }
  if (spread) cluster_barrier();
  else __syncthreads();
  if (run) {
    // the full S's ridge: its inactive diagonal is 1
    float mx[1] = {-INFINITY};
    for (int i = tid; i < a; i += K2_THREADS) mx[0] = nmax(mx[0], S(i)[i]);
    block_reduce<1, true>(mx, s.red);
    const float reg = 1e-7f * nmax(mx[0], 1.f);
    for (int i = tid; i < a; i += K2_THREADS) S(i)[i] += reg;
    __syncthreads();
    chol_rows(S, a);

    for (int i = tid; i < n; i += K2_THREADS) s.r1[i] = -s.q[i];
    for (int k = tid; k < a; k += K2_THREADS) s.r2[k] = s.bv[s.idx[k]];
    for (int r = tid; r < m; r += K2_THREADS) yp[r] = 0.f;
    __syncthreads();
    kkt_solve_c(s, a, ga, S, s.r1, s.r2, xp, s.lam);
  }
  // one refinement pass through the same factors: P xp from the rows' owners
  share(s, spread, xp, n);
  p_rows(s, xp, s.px);
  cluster_barrier();
  if (run) {
    for (int i = tid; i < n; i += K2_THREADS)
      s.r1[i] = -(s.q[i] + s.px[i] + gt_active_c(ga, a, i, s.lam));
    for (int k = tid; k < a; k += K2_THREADS) {
      const int r = s.idx[k];
      s.r2[k] = s.bv[r] - dot(ga(k), 1, xp, 1, n);
    }
    __syncthreads();
    kkt_solve_c(s, a, ga, S, s.r1, s.r2, s.dx, s.dl);
    for (int i = tid; i < n; i += K2_THREADS) xp[i] += s.dx[i];
    for (int k = tid; k < a; k += K2_THREADS) yp[s.idx[k]] = s.lam[k] + s.dl[k];
    __syncthreads();
  }

  float mxv[2] = {-INFINITY, 0.f};  // violation, non-finite flag
  // P xp and the violation of G xp on the rank's rows
  share(s, spread, xp, n);
  p_rows(s, xp, s.pxo);
  float viol[1] = {-INFINITY};
  rows_on_quads(s, s.G, s.m1 - s.m0, xp, [&](int e, float gxp) {
    const int r = s.m0 + e;
    viol[0] = nmax(viol[0], nmax(gxp - s.hi[r], s.lo[r] - gxp));
  });
  block_reduce<1, true>(viol, s.red);
  mxv[0] = cross_max(s, viol[0], xs);
  float ok = 0.f;
  if (run) {
    float sum[1] = {0.f};  // objective
    for (int r = tid; r < m; r += K2_THREADS)
      if (!isfinite(yp[r])) mxv[1] = 1.f;
    for (int i = tid; i < n; i += K2_THREADS) {
      sum[0] += 0.5f * xp[i] * s.pxo[i] + s.q[i] * xp[i];
      if (!isfinite(xp[i])) mxv[1] = 1.f;
    }
    float fl[1] = {mxv[1]};
    block_reduce<1, true>(fl, s.red);
    block_reduce<1, false>(sum, s.red);
    ok = (fl[0] == 0.f && mxv[0] <= 1e-5f * span &&
          sum[0] <= obj0 + 1e-6f * fabsf(obj0) + 1e-6f) ? 1.f : 0.f;
  }
  if (spread) ok = cross_max(s, s.rank == 0 ? ok : 0.f, xs);
  return ok != 0.f;  // the same on every rank
}

// One attempt on the set in (dm, bv): its active rows whole on every rank
// where the arena holds them and there are at most whole_rows of them (-1:
// no such bound), else spread. `spread` tells which.
__device__ bool attempt_cluster(const PolishWork& s, const float* Gb, int whole_rows, float obj0,
                                float span, float* xp, float* yp, int& xs, bool& spread) {
  const int n = s.n, ld = s.ldn;
  const int a = active_rows_in(s.dm, s.idx, s.red, s.m);
  spread = whole_floats(n, a) > s.arena_len || (whole_rows >= 0 && a > whole_rows);
  if (!spread) {
    const Local ga = {s.arena, ld};
    for (int e = threadIdx.x; e < a * n; e += K2_THREADS) {
      const int k = e / n, j = e - k * n;
      ga(k)[j] = Gb[(size_t)s.idx[k] * n + j];
    }
    __syncthreads();
    return polish_attempt_c(s, a, ga, Local{s.arena + (size_t)a * ld, ld},
                            Local{s.arena + 2 * (size_t)a * ld, a | 1}, false, obj0, span, xp,
                            yp, xs);
  }
  const int per = rows_per_rank(a, s.C);
  return polish_attempt_c(s, a, Global{Gb, s.idx, n}, Spread{s.arena, ld, per, s.rank},
                          Spread{s.arena + (size_t)per * ld, a | 1, per, s.rank}, true, obj0, span,
                          xp, yp, xs);
}

// Every rank waits until the cluster runs (A/B-2) or has read the ADMM
// layout (K2), lays the polish's working set out, and loads scenario b's P
// and G on its rows, P's lower triangle into M, q, lo and hi.
__device__ void polish_start(PolishWork& s, float* sm, const float* __restrict__ Pg,
                             const float* __restrict__ Gg, const float* __restrict__ qg,
                             const float* __restrict__ log_, const float* __restrict__ hig, int n,
                             int m, int b) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  carve_polish(s, sm, n, m, (int)cluster.num_blocks(), (int)cluster.block_rank());
  const int ld = s.ldn, tid = threadIdx.x, pn = s.n1 - s.n0, pm = s.m1 - s.m0;
  const float* Pb = Pg + (size_t)b * n * n;
  const float* Gb = Gg + (size_t)b * m * n + (size_t)s.m0 * n;
  for (int e = tid; e < pn * n; e += K2_THREADS)
    s.P[(e / n) * ld + e % n] = Pb[(size_t)s.n0 * n + e];
  for (int e = tid; e < pm * n; e += K2_THREADS) s.G[(e / n) * ld + e % n] = Gb[e];
  for (int e = tid; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) s.M[i * ld + j] = Pb[e];
  }
  for (int i = tid; i < n; i += K2_THREADS) s.q[i] = qg[(size_t)b * n + i];
  for (int r = tid; r < m; r += K2_THREADS) {
    s.lo[r] = log_[(size_t)b * m + r];
    s.hi[r] = hig[(size_t)b * m + r];
  }
}

// polish_and_select on a cluster over ``carve_polish``'s layout, x and y
// whole on every rank; rank 0 writes the outputs. whole_rows: as
// ``attempt_cluster``.
__device__ void polish_and_select_cluster(const PolishWork& s, const K2Params& p, int whole_rows,
                                          float prim, int b, const float* __restrict__ Gg,
                                          float* __restrict__ x_out, float* __restrict__ y_out,
                                          unsigned char* __restrict__ ok_out,
                                          float* __restrict__ prim_out) {
  const int n = s.n, m = s.m, tid = threadIdx.x;
  const float* Gb = Gg + (size_t)b * m * n;
  int xs = 0;  // exchanges so far

  // ---- polish: factor P once (Lp in M, Y = Lp^-1) ----
  chol_rows(Local{s.M, s.ldn}, n);
  tri_inverse_upper(s.M, s.ydiag, n, s.ldn);
  float acc[2] = {0.f, 0.f};              // x'Px, q'x
  float mh[2] = {-INFINITY, -INFINITY};   // max|hi|, max|y|
  p_rows(s, s.x, s.pxo);
  rows_on_quads(s, s.G, s.m1 - s.m0, s.x, [&](int e, float d) { put_all(s, s.Gx, s.m0 + e, d); });
  cluster_barrier();
  for (int i = tid; i < n; i += K2_THREADS) {
    acc[0] += s.x[i] * s.pxo[i];
    acc[1] += s.q[i] * s.x[i];
  }
  for (int r = tid; r < m; r += K2_THREADS) {
    mh[0] = nmax(mh[0], fabsf(s.hi[r]));
    mh[1] = nmax(mh[1], fabsf(s.y[r]));
  }
  block_reduce<2, false>(acc, s.red);
  block_reduce<2, true>(mh, s.red);
  const float obj0 = 0.5f * acc[0] + acc[1];
  const float span = nmax(mh[0], 1.f);
  const float tol = p.act_tol_rel * nmax(mh[1], 1.f);

  // attempt 1: the active set named by the ADMM duals
  for (int r = tid; r < m; r += K2_THREADS) {
    const bool alo = s.y[r] < -tol, ahi = s.y[r] > tol;
    s.dm[r] = (alo || ahi) ? 1.f : 0.f;
    s.bv[r] = alo ? s.lo[r] : s.hi[r];
  }
  __syncthreads();
  bool spread1 = false, spread2 = false;
  const bool ok1 = attempt_cluster(s, Gb, whole_rows, obj0, span, s.xp1, s.yp1, xs, spread1);

  // attempt 2: the set named by primal proximity, only where attempt 1 was
  // rejected and the two sets differ (equal sets repeat attempt 1 exactly)
  float diff[1] = {0.f};
  for (int r = tid; r < m; r += K2_THREADS) {
    const float gx = s.Gx[r], l = s.lo[r], h = s.hi[r];
    const float ptol = 1e-3f * nmax(nmax(fabsf(l), fabsf(h)), 1.f);
    const bool near_lo = (gx - l <= ptol) && (gx - l <= h - gx);
    const bool near_hi = (h - gx <= ptol) && (h - gx < gx - l);
    const bool alo = s.y[r] < -tol, ahi = s.y[r] > tol;
    if (near_lo != alo || near_hi != ahi) diff[0] = 1.f;
    s.w2[r] = near_lo ? 1.f : (near_hi ? 2.f : 0.f);  // read after the reduce
  }
  block_reduce<1, true>(diff, s.red);
  bool ok2 = false;
  if (!ok1 && diff[0] != 0.f) {
    for (int r = tid; r < m; r += K2_THREADS) {
      const float code = s.w2[r];
      s.dm[r] = code != 0.f ? 1.f : 0.f;
      s.bv[r] = code == 1.f ? s.lo[r] : s.hi[r];
    }
    __syncthreads();
    ok2 = attempt_cluster(s, Gb, whole_rows, obj0, span, s.xp2, s.yp2, xs, spread2);
  }

  // branchless-equivalent select and the primal residual of the returned x
  float* xs_ = ok1 ? s.xp1 : (ok2 ? s.xp2 : s.x);
  const float* ys = ok1 ? s.yp1 : (ok2 ? s.yp2 : s.y);
  share(s, ok1 ? spread1 : (ok2 && spread2), xs_, n);
  float vo[1] = {0.f};
  rows_on_quads(s, s.G, s.m1 - s.m0, xs_, [&](int e, float gx) {
    const int r = s.m0 + e;
    vo[0] = nmax(vo[0], nmax(nmax(gx - s.hi[r], s.lo[r] - gx), 0.f));
  });
  block_reduce<1, true>(vo, s.red);
  vo[0] = cross_max(s, vo[0], xs);
  if (s.rank == 0) {
    for (int r = tid; r < m; r += K2_THREADS) y_out[(size_t)b * m + r] = ys[r];
    for (int i = tid; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = xs_[i];
    if (tid == 0) {
      const bool ok = ok1 || ok2;
      ok_out[b] = ok ? 1 : 0;
      prim_out[b] = ok ? vo[0] : nmax(prim, vo[0]);
    }
  }
}

// K2 on a cluster: the split ADMM phase on every rank, then the polish on
// every rank (y gathered on every rank from every rank's rows, x whole on
// every rank after the ADMM; the polish layout laid over the ADMM's). n <=
// K2_THREADS and m <= 2 K2_THREADS (``cluster_rank_floats``): x and y pass
// from one layout to the other in registers.
template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas)
solve_polish_cluster_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                            const float* __restrict__ qg, const float* __restrict__ log_,
                            const float* __restrict__ hig, const float* __restrict__ xw,
                            const float* __restrict__ yw, const float* __restrict__ rho_w,
                            const K2Params p, int whole_rows, float* __restrict__ x_out,
                            float* __restrict__ y_out, unsigned char* __restrict__ ok_out,
                            float* __restrict__ prim_out, float* __restrict__ dual_out,
                            float* __restrict__ rho_out, float* __restrict__ checks_out,
                            float* __restrict__ factorizations_out) {
  extern __shared__ float sm[];
  SplitWork s;
  const int b = split_start(s, sm, p.n, p.m), n = p.n, m = p.m, tid = threadIdx.x;
  load_split(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm_split<Bk>(s, p, xw, yw, rho_w, b);
  for (int r = s.m0 + tid; r < s.m1; r += K2_THREADS) put_all(s, s.y, r, s.y[r]);
  cluster_barrier();
  const float xv = tid < n ? s.x[tid] : 0.f, y0 = tid < m ? s.y[tid] : 0.f;
  const float y1 = tid + K2_THREADS < m ? s.y[tid + K2_THREADS] : 0.f;
  PolishWork w;
  polish_start(w, sm, Pg, Gg, qg, log_, hig, n, m, b);
  if (tid < n) w.x[tid] = xv;
  if (tid < m) w.y[tid] = y0;
  if (tid + K2_THREADS < m) w.y[tid + K2_THREADS] = y1;
  __syncthreads();
  polish_and_select_cluster(w, p, whole_rows, a.prim, b, Gg, x_out, y_out, ok_out,
                            prim_out);
  if (s.rank == 0 && tid == 0) {
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
    factorizations_out[b] = a.factorizations;
  }
  cluster_barrier();
}

// A/B-1 on a cluster: the split ADMM phase; rank 0 stores x and the
// scalars, each rank its rows of y.
template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas)
ruiz_admm_cluster_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                         const float* __restrict__ qg, const float* __restrict__ log_,
                         const float* __restrict__ hig, const float* __restrict__ xw,
                         const float* __restrict__ yw, const float* __restrict__ rho_w,
                         const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                         float* __restrict__ prim_out, float* __restrict__ dual_out,
                         float* __restrict__ rho_out, float* __restrict__ checks_out,
                         float* __restrict__ factorizations_out) {
  extern __shared__ float sm[];
  SplitWork s;
  const int b = split_start(s, sm, p.n, p.m), n = p.n, m = p.m;
  load_split(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm_split<Bk>(s, p, xw, yw, rho_w, b);
  if (s.rank == 0)
    for (int i = threadIdx.x; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = s.x[i];
  for (int r = s.m0 + threadIdx.x; r < s.m1; r += K2_THREADS) y_out[(size_t)b * m + r] = s.y[r];
  if (s.rank == 0 && threadIdx.x == 0) {
    prim_out[b] = a.prim;
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
    factorizations_out[b] = a.factorizations;
  }
  cluster_barrier();
}

// A/B-2 on a cluster: the polish on every rank.
__global__ void __launch_bounds__(K2_THREADS, 2)
polish_select_cluster_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                             const float* __restrict__ qg, const float* __restrict__ log_,
                             const float* __restrict__ hig, const float* __restrict__ xin,
                             const float* __restrict__ yin, const float* __restrict__ prim_in,
                             const K2Params p, int whole_rows, float* __restrict__ x_out,
                             float* __restrict__ y_out, unsigned char* __restrict__ ok_out,
                             float* __restrict__ prim_out) {
  extern __shared__ float sm[];
  PolishWork s;
  const int b = blockIdx.x / cg::this_cluster().num_blocks(), n = p.n, m = p.m;
  polish_start(s, sm, Pg, Gg, qg, log_, hig, n, m, b);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) s.x[i] = xin[(size_t)b * n + i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) s.y[r] = yin[(size_t)b * m + r];
  __syncthreads();
  polish_and_select_cluster(s, p, whole_rows, prim_in[b], b, Gg, x_out, y_out, ok_out,
                            prim_out);
  cluster_barrier();
}

// ---- the profile path's ADMM probes ----
//
// Probe-3 admm_iterations_kernel: `iters` OSQP iterations with an explicit
//   M^-1, read by rows (not assumed symmetric).
// Probe-1 (admm_all_rounds_kernel at rounds = 1): one full round:
//   M = P' + sigma I + rho G'G
//   (row i of M is column i of P, as the TPU kernels build it), its
//   Cholesky factor with pivots sqrt(max(d, 1e-30)), Y = L^-1, M^-1 = Y'Y,
//   `iters` iterations, then the residuals max|Gx - z|, max|Px + q + G'y|
//   and the scales max|Gx|, max|z|, max|Px|, max|q|. rho is not adapted.
// Probe-2 admm_all_rounds_kernel: `rounds` such rounds in one launch, each
//   refactorized, with the OSQP rule rho <- clip(rho sqrt((prim_rel +
//   1e-12) / (dual_rel + 1e-12)), 1e-6, 1e6) after each; no early exit,
//   freeze or refactorization band.
// Replace the TPU kernels of mpc_for_av_at_intersection_tpu/ops/admm_pallas.py
// admm_iterations_pallas -> _kernel, admm_round_full_pallas -> _full_kernel
// and admm_all_rounds_pallas -> _multi_round_kernel, which only the JAX
// repository's per-stage profiler (bench_profile.py) calls. Plain versions:
// ops/admm_probes.py.
//
// Design: as K2, one CTA per scenario with its working set in shared
// memory: G (and for Probe-1/2 P, G'G formed once, M/L, Y), M^-1 and the
// vectors; ~48 KB at n = 40, m = 79 for Probe-1/2 (four CTAs per SM),
// ~22 KB for Probe-3. The TPU's GT input was only a lane layout: G' t walks
// G's columns. The probes run K2's ADMM device code: ``admm_iterate`` for
// the iterations, ``admm_residuals`` and ``rho_rule`` for the round's end,
// ``gram_cols`` for G'G. Probe-1 is Probe-2's kernel launched at
// rounds = 1, so the two agree bit for bit there. What bounds them: as the
// ADMM phase above, the SM's issue slots and shared-memory wavefronts at
// four CTAs per SM, not bytes (each scenario reads ~19 KB once) nor
// operations.

struct ProbeParams {
  int n, m, rounds, iters;
  float sigma, alpha;
};

struct ProbeWork {
  int n, m, ldn;
  float *P, *G, *GtG, *M, *Y, *Mi;
  float *q, *x, *rhs, *xt;         // n-vectors
  float *lo, *hi, *z, *y, *t;      // m-vectors
  float* red;
};

// Lay out a probe's working set from `base` (a null base only counts) and
// return its size in floats; Probe-3 (factor = false) holds only G, M^-1
// and the vectors.
__host__ __device__ size_t carve_probe(ProbeWork& s, float* base, int n, int m, bool factor) {
  s.n = n;
  s.m = m;
  s.ldn = n | 1;
  size_t off = 0;
  auto take = [&](bool used, size_t count) -> float* {
    if (!used) return nullptr;
    // both arms derived from base: the compiler keeps shared-memory loads
    // and stores (a null arm would make every access a generic one)
    float* ptr = base ? base + off : base;
    off += count;
    return ptr;
  };
  const size_t nn = (size_t)n * s.ldn, mn = (size_t)m * s.ldn;
  s.P = take(factor, nn);
  s.G = take(true, mn);
  s.GtG = take(factor, nn);
  s.M = take(factor, nn);
  s.Y = take(factor, nn);
  s.Mi = take(true, nn);
  float** nvec[] = {&s.q, &s.x, &s.rhs, &s.xt};
  for (float** v : nvec) *v = take(true, n);
  float** mvec[] = {&s.lo, &s.hi, &s.z, &s.y, &s.t};
  for (float** v : mvec) *v = take(true, m);
  s.red = take(true, NWARPS * MAX_RED);
  return off;
}

size_t probe_smem_bytes(int n, int m, bool factor) {
  ProbeWork s;
  return carve_probe(s, nullptr, n, m, factor) * sizeof(float);
}

// Load scenario b's matrix A (B, n, n) into `first` and G, q, lo, hi and
// the starting x, z, y.
__device__ void load_probe(const ProbeWork& s, float* first, const float* __restrict__ Ag,
                           const float* __restrict__ Gg, const float* __restrict__ qg,
                           const float* __restrict__ log_, const float* __restrict__ hig,
                           const float* __restrict__ xg, const float* __restrict__ zg,
                           const float* __restrict__ yg, int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  const float* Ab = Ag + (size_t)b * n * n;
  const float* Gb = Gg + (size_t)b * m * n;
  for (int e = tid; e < n * n; e += K2_THREADS) first[(e / n) * ld + e % n] = Ab[e];
  for (int e = tid; e < m * n; e += K2_THREADS) s.G[(e / n) * ld + e % n] = Gb[e];
  for (int i = tid; i < n; i += K2_THREADS) {
    s.q[i] = qg[(size_t)b * n + i];
    s.x[i] = xg[(size_t)b * n + i];
  }
  for (int r = tid; r < m; r += K2_THREADS) {
    s.lo[r] = log_[(size_t)b * m + r];
    s.hi[r] = hig[(size_t)b * m + r];
    s.z[r] = zg[(size_t)b * m + r];
    s.y[r] = yg[(size_t)b * m + r];
  }
  __syncthreads();
}

// The probe's working set as the shared iteration's operands.
template <class Bk>
__device__ Admm<Bk> probe_admm(const ProbeWork& s) {
  return {s.n, s.m, s.ldn, s.P, s.G, s.q, s.lo, s.hi, s.Mi,
          s.x, s.z, s.y, s.t, s.rhs, s.xt, s.red};
}

// p.rounds full rounds from rho: G'G once, then per round M -> L -> Y ->
// M^-1, the iterations, the residuals and the rho rule. Returns the last
// round's residuals (zeros when p.rounds is 0).
template <class Bk>
__device__ Residuals probe_rounds(const ProbeWork& s, const ProbeParams& p, float rho) {
  const int n = s.n, m = s.m, ld = s.ldn, lane = threadIdx.x & 31;
  const Admm<Bk> a = probe_admm<Bk>(s);
  gram_cols(s.G, s.GtG, n, m, ld);
  Residuals r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < p.rounds; ++k) {
    for (int i = threadIdx.x >> 5; i < n; i += NWARPS)
      for (int j = lane; j <= i; j += 32)
        s.M[i * ld + j] = (s.P[j * ld + i] + (i == j ? p.sigma : 0.f)) + rho * s.GtG[i * ld + j];
    __syncthreads();
    factor_inverse(s.M, s.Y, s.Mi, n, ld);
    admm_iterate(a, rho, p.iters, p.sigma, p.alpha);
    r = admm_residuals(a);
    rho = rho_rule(r, rho).rho;
  }
  return r;
}

// Write scenario b's x, z, y and, where res_out is given, its six
// residuals (prim, dual, max|Gx|, max|z|, max|Px|, max|q|).
__device__ void store_probe(const ProbeWork& s, int b, float* __restrict__ x_out,
                            float* __restrict__ z_out, float* __restrict__ y_out,
                            float* __restrict__ res_out, const Residuals& r) {
  const int n = s.n, m = s.m, tid = threadIdx.x;
  for (int i = tid; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = s.x[i];
  for (int w = tid; w < m; w += K2_THREADS) {
    z_out[(size_t)b * m + w] = s.z[w];
    y_out[(size_t)b * m + w] = s.y[w];
  }
  if (res_out != nullptr && tid == 0) {
    const float v[6] = {r.prim, r.dual, r.sGx, r.sz, r.sPx, r.sq};
    for (int k = 0; k < 6; ++k) res_out[(size_t)b * 6 + k] = v[k];
  }
}

template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas)
admm_iterations_kernel(const float* __restrict__ Minv, const float* __restrict__ Gg,
                       const float* __restrict__ qg, const float* __restrict__ log_,
                       const float* __restrict__ hig, const float* __restrict__ rho_g,
                       const float* __restrict__ xg, const float* __restrict__ zg,
                       const float* __restrict__ yg, const ProbeParams p,
                       float* __restrict__ x_out, float* __restrict__ z_out,
                       float* __restrict__ y_out) {
  extern __shared__ float sm[];
  ProbeWork s;
  carve_probe(s, sm, p.n, p.m, false);
  const int b = blockIdx.x;
  load_probe(s, s.Mi, Minv, Gg, qg, log_, hig, xg, zg, yg, b);
  admm_iterate(probe_admm<Bk>(s), rho_g[b], p.iters, p.sigma, p.alpha);
  store_probe(s, b, x_out, z_out, y_out, nullptr, Residuals{});
}

template <class Bk>
__global__ void __launch_bounds__(K2_THREADS, Bk::kCtas)
admm_all_rounds_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                       const float* __restrict__ qg, const float* __restrict__ log_,
                       const float* __restrict__ hig, const float* __restrict__ rho_g,
                       const float* __restrict__ xg, const float* __restrict__ zg,
                       const float* __restrict__ yg, const ProbeParams p,
                       float* __restrict__ x_out, float* __restrict__ z_out,
                       float* __restrict__ y_out, float* __restrict__ res_out) {
  extern __shared__ float sm[];
  ProbeWork s;
  carve_probe(s, sm, p.n, p.m, true);
  const int b = blockIdx.x;
  load_probe(s, s.P, Pg, Gg, qg, log_, hig, xg, zg, yg, b);
  const Residuals r = probe_rounds<Bk>(s, p, rho_g[b]);
  store_probe(s, b, x_out, z_out, y_out, res_out, r);
}

K2Params make_params(int n, int m, const int* iparams, const float* fparams) {
  K2Params p;
  p.n = n;
  p.m = m;
  p.ruiz_iters = iparams[0];
  p.max_checks = iparams[1];
  p.check_iters = iparams[2];
  p.sigma = fparams[0];
  p.alpha = fparams[1];
  p.eps = fparams[2];
  p.band = fparams[3];
  p.stall_cap = fparams[4];
  p.stall_ratio = fparams[5];
  p.stall_prim_cap = fparams[6];
  p.act_tol_rel = fparams[7];
  return p;
}

// One CTA per scenario with the working set of `phases` as dynamic shared
// memory. Returns the CUDA error code of the launch (0 = launched).
template <typename Kernel, typename... Args>
int launch_smem(Kernel kernel, size_t smem, int B, void* stream, Args... args) {
  if (B <= 0) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, K2_THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int phases, int B, int n, int m, void* stream, Args... args) {
  return launch_smem(kernel, smem_bytes(n, m, phases), B, stream, args...);
}

// The instantiation of an ADMM kernel for this (n, m)'s horizon bucket.
#define BY_BUCKET(kernel, n, m) (in_t13(n, m) ? kernel<BucketT13> : kernel<BucketT20>)
// ... and of a cluster variant, for its cluster bucket.
#define BY_CLUSTER_BUCKET(kernel, n, m) (in_c40(n, m) ? kernel<BucketC40> : kernel<BucketC60>)

// Besides the CUDA error codes (positive): the layout of `phases` does not
// fit a cluster of this size; no cluster of it fits the card.
constexpr int kNoLayout = -1, kNoCluster = -2;

// The launch configuration of a cluster kernel: C CTAs a scenario, grid B C,
// `smem` bytes of dynamic shared memory in each CTA.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int B, int C, size_t smem, void* stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(B * C);
    cfg.blockDim = dim3(K2_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of C CTAs of `kernel` with `smem` bytes each that the card runs at
// once (after setting the kernel's shared-memory limit); a negative CUDA
// error code where the query fails.
template <typename Kernel>
int active_clusters(Kernel kernel, int C, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  const ClusterLaunch l(1, C, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &l.cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

// A cluster kernel on C CTAs a scenario with the cluster layout of `phases`
// as each CTA's dynamic shared memory. Fails loudly: kNoLayout, kNoCluster
// or the CUDA error code of the launch (0 = launched).
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int phases, int B, int n, int m, int C, void* stream,
                   Args... args) {
  const size_t smem = cluster_rank_floats(n, m, phases, C) * sizeof(float);
  if (smem == 0) return kNoLayout;
  if (B <= 0) return 0;
  const int clusters = active_clusters(kernel, C, smem);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return kNoCluster;
  const ClusterLaunch l(B, C, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes: P (B,n,n), G (B,m,n), q (B,n), lo/hi (B,m), warm x (B,n), y (B,m),
// rho (B,); outputs x (B,n), y (B,m), ok (B,) bool, prim/dual/rho/checks/
// factorizations (B,); all float32 unless noted, contiguous, on the device. `iparams` is
// a host array {ruiz_iters, max_checks, check_iters, whole_rows}; `fparams` a host
// array {sigma, alpha, eps, band, stall_cap, stall_ratio, stall_prim_cap,
// act_tol_rel}. Each entry returns the CUDA error code of its launch. On a
// cluster (cluster > 1) K2's iparams[3] and A/B-2's whole_rows bound the
// active rows a polish attempt keeps whole on every rank (-1: as many as the
// arena holds; the card tests pass 0 to drive the spread rows).
int k2_solve_polish(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* xw, const float* yw, const float* rho_w,
                    int B, int n, int m, int cluster, const int* iparams, const float* fparams,
                    float* x, float* y, unsigned char* ok, float* prim, float* dual,
                    float* rho, float* checks, float* factorizations, void* stream) {
  const K2Params p = make_params(n, m, iparams, fparams);
  if (cluster > 1)
    return launch_cluster(BY_CLUSTER_BUCKET(solve_polish_cluster_kernel, n, m), kBoth, B, n, m,
                          cluster, stream,
                          P, G, q, lo, hi, xw, yw, rho_w, p, iparams[3], x, y, ok, prim, dual,
                          rho, checks, factorizations);
  return launch(BY_BUCKET(solve_polish_kernel, n, m), kBoth, B, n, m, stream, P, G, q, lo, hi, xw, yw, rho_w,
                p, x, y, ok, prim, dual, rho, checks, factorizations);
}

// A/B-1: as k2_solve_polish without the polish; x and y are the unscaled
// ADMM iterates, prim and dual its scaled residuals.
int ruiz_admm_all_rounds(const float* P, const float* G, const float* q, const float* lo,
                         const float* hi, const float* xw, const float* yw, const float* rho_w,
                         int B, int n, int m, int cluster, const int* iparams,
                         const float* fparams, float* x, float* y, float* prim, float* dual,
                         float* rho, float* checks, float* factorizations, void* stream) {
  const K2Params p = make_params(n, m, iparams, fparams);
  if (cluster > 1)
    return launch_cluster(BY_CLUSTER_BUCKET(ruiz_admm_cluster_kernel, n, m), kAdmm, B, n, m,
                          cluster, stream,
                          P, G, q, lo, hi, xw, yw, rho_w, p, x, y, prim, dual, rho, checks,
                          factorizations);
  return launch(BY_BUCKET(ruiz_admm_kernel, n, m), kAdmm, B, n, m, stream, P, G, q, lo, hi, xw, yw, rho_w,
                p, x, y, prim, dual, rho, checks, factorizations);
}

// A/B-2: the polish of an ADMM solution (x (B,n), y (B,m), its primal
// residual prim (B,)); outputs x, y, ok, prim as k2_solve_polish.
int polish_select(const float* P, const float* G, const float* q, const float* lo,
                  const float* hi, const float* x_in, const float* y_in, const float* prim_in,
                  int B, int n, int m, int cluster, int whole_rows, float act_tol_rel, float* x,
                  float* y, unsigned char* ok, float* prim, void* stream) {
  K2Params p = {};
  p.n = n;
  p.m = m;
  p.act_tol_rel = act_tol_rel;
  if (cluster > 1)
    return launch_cluster(polish_select_cluster_kernel, kPolish, B, n, m, cluster, stream, P, G,
                          q, lo, hi, x_in, y_in, prim_in, p, whole_rows, x, y, ok, prim);
  return launch(polish_select_kernel, kPolish, B, n, m, stream, P, G, q, lo, hi, x_in, y_in,
                prim_in, p, x, y, ok, prim);
}

// Probe-3: `iters` iterations from (x, z, y) with M^-1 `Minv` (B,n,n);
// shapes as above, rho (B,); outputs x (B,n), z (B,m), y (B,m).
int admm_iterations(const float* Minv, const float* G, const float* q, const float* lo,
                    const float* hi, const float* rho, const float* x, const float* z,
                    const float* y, int B, int n, int m, int iters, float sigma, float alpha,
                    float* x_out, float* z_out, float* y_out, void* stream) {
  const ProbeParams p = {n, m, 0, iters, sigma, alpha};
  return launch_smem(BY_BUCKET(admm_iterations_kernel, n, m), probe_smem_bytes(n, m, false), B, stream, Minv, G,
                     q, lo, hi, rho, x, z, y, p, x_out, z_out, y_out);
}

// Probe-1: one full round, Probe-2's kernel at rounds = 1; res (B,6) gets
// prim, dual, max|Gx|, max|z|, max|Px|, max|q|.
int admm_round_full(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* rho, const float* x, const float* z,
                    const float* y, int B, int n, int m, int iters, float sigma, float alpha,
                    float* x_out, float* z_out, float* y_out, float* res, void* stream) {
  const ProbeParams p = {n, m, 1, iters, sigma, alpha};
  return launch_smem(BY_BUCKET(admm_all_rounds_kernel, n, m), probe_smem_bytes(n, m, true), B, stream, P, G, q,
                     lo, hi, rho, x, z, y, p, x_out, z_out, y_out, res);
}

// Probe-2: `rounds` full rounds with the rho rule between them; res as
// Probe-1's, of the last round.
int admm_all_rounds(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* rho, const float* x, const float* z,
                    const float* y, int B, int n, int m, int rounds, int iters, float sigma,
                    float alpha, float* x_out, float* z_out, float* y_out, float* res,
                    void* stream) {
  const ProbeParams p = {n, m, rounds, iters, sigma, alpha};
  return launch_smem(BY_BUCKET(admm_all_rounds_kernel, n, m), probe_smem_bytes(n, m, true), B, stream, P, G, q,
                     lo, hi, rho, x, z, y, p, x_out, z_out, y_out, res);
}

// Dynamic shared memory of one CTA of one kernel (0: K2, 1: A/B-1, 2:
// A/B-2, 3: Probe-3, 4: Probe-1 and Probe-2) at this (n, m), in bytes; -1
// for another kernel number.
int admm_smem_bytes(int kernel, int n, int m) {
  const int phases[] = {kBoth, kAdmm, kPolish};
  if (kernel < 0 || kernel > 4) return -1;
  return (int)(kernel < 3 ? smem_bytes(n, m, phases[kernel])
                          : probe_smem_bytes(n, m, kernel != 3));
}

// CTAs a scenario of one kernel (numbered as above) takes at this (n, m): 1
// where one CTA holds its working set, 2 .. 4 for K2, A/B-1 and A/B-2 on
// a cluster (the probes stay on one CTA), 0 where none holds it; -1 for
// another kernel number. The wrappers' ``cluster_size`` is held to it.
int admm_cluster_size(int kernel, int n, int m) {
  const int phases[] = {kBoth, kAdmm, kPolish};
  if (kernel < 0 || kernel > 4) return -1;
  if (kernel < 3) return cluster_size(n, m, phases[kernel]);
  return probe_smem_bytes(n, m, kernel != 3) <= RANK_BYTES ? 1 : 0;
}

// Dynamic shared memory of each CTA of a scenario of one kernel on C CTAs,
// in bytes: admm_smem_bytes at C = 1, the largest rank of the cluster layout
// at C = 2 .. 4 (K2, A/B-1, A/B-2); 0 where it does not fit; -1 for another
// kernel number.
int admm_rank_bytes(int kernel, int n, int m, int C) {
  const int phases[] = {kBoth, kAdmm, kPolish};
  if (kernel < 0 || kernel > 4) return -1;
  if (C == 1) return admm_smem_bytes(kernel, n, m);
  if (kernel > 2) return 0;
  return (int)(cluster_rank_floats(n, m, phases[kernel], C) * sizeof(float));
}

// The instantiation of kernel 0-4 that runs a scenario on C CTAs.
static const void* admm_function(int kernel, int n, int m, int C) {
  if (C > 1) {
    const void* fns[] = {(const void*)BY_CLUSTER_BUCKET(solve_polish_cluster_kernel, n, m),
                         (const void*)BY_CLUSTER_BUCKET(ruiz_admm_cluster_kernel, n, m),
                         (const void*)polish_select_cluster_kernel};
    return kernel < 3 ? fns[kernel] : nullptr;
  }
  const void* fns[] = {(const void*)BY_BUCKET(solve_polish_kernel, n, m),
                       (const void*)BY_BUCKET(ruiz_admm_kernel, n, m),
                       (const void*)polish_select_kernel,
                       (const void*)BY_BUCKET(admm_iterations_kernel, n, m),
                       (const void*)BY_BUCKET(admm_all_rounds_kernel, n, m)};
  return fns[kernel];
}

// CTAs of one kernel (numbered as above) that fit an SM at this (n, m), as
// the CUDA runtime computes it from registers and shared memory, for the
// instantiation and the shared memory a CTA of it takes at the cluster size
// ``admm_cluster_size`` picks; negative: the CUDA error code (-1 also for
// a problem no cluster holds).
int admm_blocks_per_sm(int kernel, int n, int m) {
  if (kernel < 0 || kernel > 4) return -1;
  const int C = admm_cluster_size(kernel, n, m);
  if (C < 1) return -1;
  const void* fn = admm_function(kernel, n, m, C);
  const size_t smem = (size_t)admm_rank_bytes(kernel, n, m, C);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, K2_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Clusters of C CTAs of kernel 0-2 that the card runs at once at this
// (n, m), as cudaOccupancyMaxActiveClusters computes it; 0 where the layout
// does not fit; negative: the CUDA error code, or -1 for another kernel or C.
int admm_active_clusters(int kernel, int n, int m, int C) {
  if (kernel < 0 || kernel > 2 || C < 2 || C > MAX_RANKS) return -1;
  const size_t smem = (size_t)admm_rank_bytes(kernel, n, m, C);
  if (smem == 0) return 0;
  return active_clusters(admm_function(kernel, n, m, C), C, smem);
}

}  // extern "C"
