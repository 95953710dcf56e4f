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
// What bounds it on an H100: not bytes (each scenario reads ~19 KB once;
// A/B-2 reads P and G a second time). An iteration is three
// barrier-separated matvec phases, one thread per output entry walking its
// dot product with four partial sums; at four CTAs per SM (the probes) the
// SM's issue slots and shared-memory wavefronts set its time, at two (K2)
// the latency of each phase and its barrier, and the column-by-column
// Cholesky of the ADMM matrix and of P and the inverse L^-1 add serial
// chains. All matrices have an odd leading dimension, so row and column
// walks are free of bank conflicts at any n (odd n included). Splitting
// each dot product across a group of 8, 16 or 32 lanes with a shuffle
// butterfly was measured slower for every ADMM kernel (PERF.md): the extra
// instructions cost more than the shorter chains save. Later work: keeping
// G and M^-1 in registers (fewer shared-memory reads an iteration, at the
// cost of occupancy), several scenarios per CTA, the ADMM's factorization in
// fewer barriers, P's side of the polish and a warp path for a <= 32.
//
// Numerics follow the TPU kernel: Cholesky pivots are clamped with
// sqrt(max(d, 1e-30)), the polish's S gets a 1e-7 * max(diag S, 1) ridge,
// and max/clip propagate NaN as jnp.max / jnp.clip do.

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

// out = G'G, lower triangle, for the m x n matrix G: one thread per entry
// walks two columns of G.
__device__ void gram_cols(const float* G, float* out, int n, int m, int ld) {
  for (int e = threadIdx.x; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) out[i * ld + j] = dot(G + i, ld, G + j, ld, m);
  }
  __syncthreads();
}

// In-place lower Cholesky of the N x N matrix A (leading dimension ld);
// only the lower triangle is read or written.
__device__ void chol_inplace(float* A, int N, int ld) {
  for (int j = 0; j < N; ++j) {
    const float ljj = sqrtf(nmax(A[j * ld + j], 1e-30f));
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < N; i += K2_THREADS) A[i * ld + j] /= ljj;
    if (threadIdx.x == 0) A[j * ld + j] = ljj;
    __syncthreads();
    const int rem = N - j - 1;
    for (int e = threadIdx.x; e < rem * rem; e += K2_THREADS) {
      const int i = j + 1 + e / rem, c = j + 1 + e % rem;
      if (c <= i) A[i * ld + c] -= A[i * ld + j] * A[c * ld + j];
    }
    __syncthreads();
  }
}

// Y = L^-1 (lower) by forward substitution, one row at a time.
__device__ void tri_inverse(const float* L, float* Y, int N, int ld) {
  for (int r = 0; r < N; ++r) {
    const float lrr = L[r * ld + r];
    for (int c = threadIdx.x; c <= r; c += K2_THREADS) {
      float s = (c == r) ? 1.f : 0.f;
      for (int k = c; k < r; ++k) s -= L[r * ld + k] * Y[k * ld + c];
      Y[r * ld + c] = s / lrr;
    }
    __syncthreads();
  }
}

// out = Y'Y (full, symmetric) for lower-triangular Y.
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

// Solve (L L') out = b for one right-hand side, L in place in A; warp 0
// walks the two triangular chains, the lanes split each dot product.
__device__ void chol_solve_vec(const float* L, int N, int ld, const float* b, float* w,
                               float* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
      for (int k = lane; k < j; k += 32) s += L[j * ld + k] * w[k];
      s = warp_sum(s);
      if (lane == 0) w[j] = (b[j] - s) / L[j * ld + j];
      __syncwarp();
    }
    for (int j = N - 1; j >= 0; --j) {
      float s = 0.f;
      for (int k = j + 1 + lane; k < N; k += 32) s += L[k * ld + j] * out[k];
      s = warp_sum(s);
      if (lane == 0) out[j] = (w[j] - s) / L[j * ld + j];
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
    float* ptr = base ? base + off : nullptr;
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

// M = Ps + sigma I + rho Gs'Gs -> L -> Y = L^-1 -> Minv = Y'Y
__device__ void factorize(const Work& s, float rho, float sigma) {
  const int n = s.n, ld = s.ldn;
  for (int e = threadIdx.x; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j > i) continue;
    s.M[i * ld + j] = (s.Ps[i * ld + j] + (i == j ? sigma : 0.f)) + rho * s.GtG[i * ld + j];
  }
  __syncthreads();
  chol_inplace(s.M, n, ld);
  tri_inverse(s.M, s.Y, n, ld);
  gram_lower(s.Y, s.Mi, n, ld);
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

// The rows with dm = 1, ascending, into s.idx (a block prefix sum of
// warp ballots); returns their count a, the same in all threads.
__device__ int active_rows(const Work& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* cnt = reinterpret_cast<int*>(s.red);
  int a = 0;
  for (int r0 = 0; r0 < s.m; r0 += K2_THREADS) {
    const int r = r0 + threadIdx.x;
    const bool act = r < s.m && s.dm[r] != 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    __syncthreads();  // the scratch is free
    if (lane == 0) cnt[warp] = __popc(bal);
    __syncthreads();
    int before = a;
    for (int w = 0; w < NWARPS; ++w) {
      if (w == warp) before = a;
      a += cnt[w];
    }
    if (act) s.idx[before + __popc(bal & ((1u << lane) - 1u))] = r;
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
  chol_solve_vec(s.S, a, s.ldm, s.w, s.w2, dl);
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
  const int a = active_rows(s);
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
  chol_inplace(s.S, a, ldm);

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

// The operands of the ADMM iteration and of its residual check: K2 and
// A/B-1 pass the scaled problem (Ps, Gs, qs, los, his), the probes the
// problem as given; M^-1 is read by rows.
struct Admm {
  int n, m, ld;
  const float *P, *G, *q, *lo, *hi, *Mi;
  float *x, *z, *y, *t, *rhs, *xt, *red;
};

// `iters` OSQP iterations on x, z, y at penalty rho: three barrier-separated
// matvec phases (G't by columns, M^-1 by rows, G by rows), one thread per
// output entry.
__device__ void admm_iterate(const Admm& a, float rho, int iters, float sigma, float alpha) {
  const int n = a.n, m = a.m, ld = a.ld, tid = threadIdx.x;
  for (int r = tid; r < m; r += K2_THREADS) a.t[r] = rho * a.z[r] - a.y[r];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int i = tid; i < n; i += K2_THREADS)
      a.rhs[i] = sigma * a.x[i] - a.q[i] + dot(a.G + i, ld, a.t, m);
    __syncthreads();
    for (int i = tid; i < n; i += K2_THREADS) a.xt[i] = dot(a.Mi + i * ld, 1, a.rhs, n);
    __syncthreads();
    for (int w = tid; w < m + n; w += K2_THREADS) {
      if (w < m) {
        const float gxt = dot(a.G + w * ld, 1, a.xt, n);
        const float zt = alpha * gxt + (1.f - alpha) * a.z[w];
        const float zn = clip(zt + a.y[w] / rho, a.lo[w], a.hi[w]);
        const float yn = a.y[w] + rho * (zt - zn);
        a.z[w] = zn;
        a.y[w] = yn;
        a.t[w] = rho * zn - yn;
      } else {
        const int i = w - m;
        a.x[i] = alpha * a.xt[i] + (1.f - alpha) * a.x[i];
      }
    }
    __syncthreads();
  }
}

struct Residuals {
  float prim, dual, sGx, sz, sPx, sq;
};

// max|Gx - z|, max|Px + q + G'y| and the scales max|Gx|, max|z|, max|Px|,
// max|q| (the same in all threads).
__device__ Residuals admm_residuals(const Admm& a) {
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
  float prim, dual, rho, checks;
};

// Ruiz equilibration and the warm-started adaptive ADMM of scenario b.
// Leaves the unscaled x and y in s.x and s.y (synchronized) and returns the
// ADMM's scaled primal and dual residuals, its final rho and the check
// blocks run.
__device__ AdmmOut ruiz_admm(const Work& s, const K2Params& p, const float* __restrict__ xw,
                             const float* __restrict__ yw, const float* __restrict__ rho_w,
                             int b) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  for (int i = tid; i < n; i += K2_THREADS) s.d[i] = 1.f;
  for (int r = tid; r < m; r += K2_THREADS) s.e[r] = 1.f;
  __syncthreads();

  // ---- modified Ruiz equilibration + cost normalization ----
  float c = 1.f;
  for (int it = 0; it < p.ruiz_iters; ++it) {
    for (int j = tid; j < n; j += K2_THREADS) {  // column maxima of |Ps|, |Gs|
      float mp = 0.f, mg = 0.f;
      for (int i = 0; i < n; ++i) mp = nmax(mp, s.d[i] * fabsf(s.P[i * ld + j]));
      for (int r = 0; r < m; ++r) mg = nmax(mg, s.e[r] * fabsf(s.G[r * ld + j]));
      s.tn[j] = nmax(c * s.d[j] * mp, s.d[j] * mg);
    }
    for (int r = tid; r < m; r += K2_THREADS) {  // row maxima of |Gs|
      float mg = 0.f;
      for (int j = 0; j < n; ++j) mg = nmax(mg, s.d[j] * fabsf(s.G[r * ld + j]));
      s.t[r] = s.e[r] * mg;
    }
    __syncthreads();
    for (int j = tid; j < n; j += K2_THREADS) s.d[j] = s.d[j] / sqrtf(nmax(s.tn[j], 1e-8f));
    for (int r = tid; r < m; r += K2_THREADS) s.e[r] = s.e[r] / sqrtf(nmax(s.t[r], 1e-8f));
    __syncthreads();
    float sm1[1] = {0.f}, mx1[1] = {0.f};
    for (int j = tid; j < n; j += K2_THREADS) {
      float mp = 0.f;
      for (int i = 0; i < n; ++i) mp = nmax(mp, s.d[i] * fabsf(s.P[i * ld + j]));
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
  const Admm a = {n, m, ld, s.Ps, s.Gs, s.qs, s.los, s.his, s.Mi,
                  s.x, s.z, s.y, s.t, s.rhs, s.xt, s.red};
  const float rho_in = rho_w[b];
  float rho_f = rho_in, rho_p = rho_in, prev_score = 1e30f, prim = 0.f, dual = 0.f;
  float checks = 0.f;
  bool refac = true, conv = false;
  for (int k = 0; k < p.max_checks && !conv; ++k) {
    const float rho = refac ? rho_p : rho_f;
    if (refac) factorize(s, rho, p.sigma);
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

  return {prim, dual, rho_f, checks};
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
  chol_inplace(s.M, n, ld);
  tri_inverse(s.M, s.Y, n, ld);
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

__global__ void __launch_bounds__(K2_THREADS, 2)
solve_polish_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                    const float* __restrict__ qg, const float* __restrict__ log_,
                    const float* __restrict__ hig, const float* __restrict__ xw,
                    const float* __restrict__ yw, const float* __restrict__ rho_w,
                    const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                    unsigned char* __restrict__ ok_out, float* __restrict__ prim_out,
                    float* __restrict__ dual_out, float* __restrict__ rho_out,
                    float* __restrict__ checks_out) {
  extern __shared__ float sm[];
  Work s;
  carve(s, sm, p.n, p.m, kBoth);
  const int b = blockIdx.x;
  load_problem(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm(s, p, xw, yw, rho_w, b);
  polish_and_select(s, p, a.prim, b, x_out, y_out, ok_out, prim_out);
  if (threadIdx.x == 0) {
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
  }
}

// Three CTAs of ~69 KB fit an SM's shared memory at n = 40, m = 79, four
// of ~30 KB at n = 26, m = 51 (T = 13). The bound of four CTAs caps the
// registers at 64 so that the registers do not take the fourth: left at
// three, the compiler spends up to 80 on the shared ADMM device code.
__global__ void __launch_bounds__(K2_THREADS, 4)
ruiz_admm_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                 const float* __restrict__ qg, const float* __restrict__ log_,
                 const float* __restrict__ hig, const float* __restrict__ xw,
                 const float* __restrict__ yw, const float* __restrict__ rho_w,
                 const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                 float* __restrict__ prim_out, float* __restrict__ dual_out,
                 float* __restrict__ rho_out, float* __restrict__ checks_out) {
  extern __shared__ float sm[];
  Work s;
  carve(s, sm, p.n, p.m, kAdmm);
  const int b = blockIdx.x, n = p.n, m = p.m;
  load_problem(s, Pg, Gg, qg, log_, hig, b);
  const AdmmOut a = ruiz_admm(s, p, xw, yw, rho_w, b);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) x_out[(size_t)b * n + i] = s.x[i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) y_out[(size_t)b * m + r] = s.y[r];
  if (threadIdx.x == 0) {
    prim_out[b] = a.prim;
    dual_out[b] = a.dual;
    rho_out[b] = a.rho;
    checks_out[b] = a.checks;
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
    float* ptr = base ? base + off : nullptr;
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
__device__ Admm probe_admm(const ProbeWork& s) {
  return {s.n, s.m, s.ldn, s.P, s.G, s.q, s.lo, s.hi, s.Mi,
          s.x, s.z, s.y, s.t, s.rhs, s.xt, s.red};
}

// p.rounds full rounds from rho: G'G once, then per round M -> L -> Y ->
// M^-1, the iterations, the residuals and the rho rule. Returns the last
// round's residuals (zeros when p.rounds is 0).
__device__ Residuals probe_rounds(const ProbeWork& s, const ProbeParams& p, float rho) {
  const int n = s.n, m = s.m, ld = s.ldn, tid = threadIdx.x;
  const Admm a = probe_admm(s);
  gram_cols(s.G, s.GtG, n, m, ld);
  Residuals r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < p.rounds; ++k) {
    for (int e = tid; e < n * n; e += K2_THREADS) {
      const int i = e / n, j = e - i * n;
      if (j > i) continue;
      s.M[i * ld + j] = (s.P[j * ld + i] + (i == j ? p.sigma : 0.f)) + rho * s.GtG[i * ld + j];
    }
    __syncthreads();
    chol_inplace(s.M, n, ld);
    tri_inverse(s.M, s.Y, n, ld);
    gram_lower(s.Y, s.Mi, n, ld);
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

__global__ void __launch_bounds__(K2_THREADS, 4)
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
  admm_iterate(probe_admm(s), rho_g[b], p.iters, p.sigma, p.alpha);
  store_probe(s, b, x_out, z_out, y_out, nullptr, Residuals{});
}

__global__ void __launch_bounds__(K2_THREADS, 4)
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
  const Residuals r = probe_rounds(s, p, rho_g[b]);
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

}  // namespace

extern "C" {

// Shapes: P (B,n,n), G (B,m,n), q (B,n), lo/hi (B,m), warm x (B,n), y (B,m),
// rho (B,); outputs x (B,n), y (B,m), ok (B,) bool, prim/dual/rho/checks
// (B,); all float32 unless noted, contiguous, on the device. `iparams` is
// a host array {ruiz_iters, max_checks, check_iters}; `fparams` a host
// array {sigma, alpha, eps, band, stall_cap, stall_ratio, stall_prim_cap,
// act_tol_rel}. Each entry returns the CUDA error code of its launch.
int k2_solve_polish(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* xw, const float* yw, const float* rho_w,
                    int B, int n, int m, const int* iparams, const float* fparams,
                    float* x, float* y, unsigned char* ok, float* prim, float* dual,
                    float* rho, float* checks, void* stream) {
  return launch(solve_polish_kernel, kBoth, B, n, m, stream, P, G, q, lo, hi, xw, yw, rho_w,
                make_params(n, m, iparams, fparams), x, y, ok, prim, dual, rho, checks);
}

// A/B-1: as k2_solve_polish without the polish; x and y are the unscaled
// ADMM iterates, prim and dual its scaled residuals.
int ruiz_admm_all_rounds(const float* P, const float* G, const float* q, const float* lo,
                         const float* hi, const float* xw, const float* yw, const float* rho_w,
                         int B, int n, int m, const int* iparams, const float* fparams,
                         float* x, float* y, float* prim, float* dual, float* rho,
                         float* checks, void* stream) {
  return launch(ruiz_admm_kernel, kAdmm, B, n, m, stream, P, G, q, lo, hi, xw, yw, rho_w,
                make_params(n, m, iparams, fparams), x, y, prim, dual, rho, checks);
}

// A/B-2: the polish of an ADMM solution (x (B,n), y (B,m), its primal
// residual prim (B,)); outputs x, y, ok, prim as k2_solve_polish.
int polish_select(const float* P, const float* G, const float* q, const float* lo,
                  const float* hi, const float* x_in, const float* y_in, const float* prim_in,
                  int B, int n, int m, float act_tol_rel, float* x, float* y, unsigned char* ok,
                  float* prim, void* stream) {
  K2Params p = {};
  p.n = n;
  p.m = m;
  p.act_tol_rel = act_tol_rel;
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
  return launch_smem(admm_iterations_kernel, probe_smem_bytes(n, m, false), B, stream, Minv, G,
                     q, lo, hi, rho, x, z, y, p, x_out, z_out, y_out);
}

// Probe-1: one full round, Probe-2's kernel at rounds = 1; res (B,6) gets
// prim, dual, max|Gx|, max|z|, max|Px|, max|q|.
int admm_round_full(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* rho, const float* x, const float* z,
                    const float* y, int B, int n, int m, int iters, float sigma, float alpha,
                    float* x_out, float* z_out, float* y_out, float* res, void* stream) {
  const ProbeParams p = {n, m, 1, iters, sigma, alpha};
  return launch_smem(admm_all_rounds_kernel, probe_smem_bytes(n, m, true), B, stream, P, G, q,
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
  return launch_smem(admm_all_rounds_kernel, probe_smem_bytes(n, m, true), B, stream, P, G, q,
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

// CTAs of one kernel (numbered as above) that fit an SM at this (n, m), as
// the CUDA runtime computes it from registers and shared memory; negative:
// the CUDA error code.
int admm_blocks_per_sm(int kernel, int n, int m) {
  const void* fns[] = {(const void*)solve_polish_kernel, (const void*)ruiz_admm_kernel,
                       (const void*)polish_select_kernel, (const void*)admm_iterations_kernel,
                       (const void*)admm_all_rounds_kernel};
  if (kernel < 0 || kernel > 4) return -1;
  const size_t smem = (size_t)admm_smem_bytes(kernel, n, m);
  cudaError_t err = cudaFuncSetAttribute(fns[kernel], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[kernel], K2_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
