// K2: the whole box-QP solve in one launch: modified Ruiz equilibration,
// warm-started adaptive ADMM, and the two-attempt active-set polish.
//
// Replaces the TPU kernel mpc_for_av_at_intersection_tpu/ops/admm_pallas.py
// (solve_polish_fused_pallas -> _solve_polish_kernel, with _ruiz_admm_body,
// _polish_body, _chol_inplace_panel, _tri_inverse_fsub, _gram_from_y).
// Plain version: mpc/qp.py::solve_box_qp_batched (called through
// ops/admm.py).
//
// Problem: min 1/2 x'Px + q'x  s.t.  lo <= Gx <= hi, x in R^n, m rows.
//
// Design: one CTA per scenario, with its whole working set in shared memory
// (P, G, the scaled Ps/Gs, Gs'Gs, M/L, L^-1, M^-1 and the polish's Schur
// matrix S: ~97 KB at n = 40, m = 79, so two CTAs per SM). Each CTA runs its
// own check loop and leaves it when its scenario converges or stalls. The
// TPU kernel iterates a group of 128 scenarios until all have converged,
// but frozen scenarios do not move and a group refactorization recomputes
// the same factor for them, so per-scenario exit is the same algorithm.
// The second polish attempt likewise runs only where its scenario needs it.
//
// What bounds it on an H100: latency of serial dependency chains inside
// each CTA (ADMM iterations, the column-by-column Cholesky, triangular
// solves), not bytes: each scenario reads ~19 KB once. The ADMM inner loop
// is three barrier-separated matvec phases; dot products use four partial
// sums, and all matrices have an odd leading dimension so that row and
// column walks are free of shared-memory bank conflicts. Later work: more
// threads per dot product, and several scenarios per CTA.
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

// Shared-memory working set of one scenario.
struct Work {
  int n, m, ldn, ldm;
  float *P, *G, *Ps, *Gs, *GtG, *M, *Y, *Mi, *S;
  // n-vectors
  float *q, *d, *qs, *x, *xt, *rhs, *Px, *tn, *xp1, *xp2, *u, *pir, *dx, *r1, *gv;
  // m-vectors
  float *lo, *hi, *e, *los, *his, *z, *y, *t, *Gx, *yp1, *yp2, *dm, *bv, *w, *dl, *w2, *lam, *r2;
  float* red;
};

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

// One KKT solve on the current active set (mask dm, Schur factor in S):
// P dx + G'D dl = r1 ; D G dx = r2 ; (I - D) dl = 0.
__device__ void kkt_solve(const Work& s, const float* r1, const float* r2, float* dx,
                          float* dl) {
  const int n = s.n, m = s.m, ld = s.ldn;
  apply_pinv(s, r1, s.pir);
  for (int r = threadIdx.x; r < m; r += K2_THREADS)
    s.w[r] = s.dm[r] * dot(s.G + r * ld, 1, s.pir, n) - r2[r];
  __syncthreads();
  chol_solve_vec(s.S, m, s.ldm, s.w, s.w2, dl);
  for (int r = threadIdx.x; r < m; r += K2_THREADS) s.w[r] = s.dm[r] * dl[r];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += K2_THREADS) s.gv[j] = dot(s.G + j, ld, s.w, m);
  __syncthreads();
  apply_pinv(s, s.gv, dx);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) dx[i] = s.pir[i] - dx[i];
  __syncthreads();
}

// One polish attempt on the active set in (dm, bv): Schur factor, KKT
// solve, one refinement pass, accept test. Returns ok (same in all threads).
__device__ bool polish_attempt(const Work& s, float obj0, float span, float* xp, float* yp) {
  const int n = s.n, m = s.m, ld = s.ldn, ldm = s.ldm;
  // S = D Vt Vt' D + (I - D), lower triangle; Vt = G Y' lives in Gs
  for (int e = threadIdx.x; e < m * m; e += K2_THREADS) {
    const int i = e / m, j = e - i * m;
    if (j > i) continue;
    const float di = s.dm[i], dj = s.dm[j];
    float v = 0.f;
    if (di != 0.f && dj != 0.f) v = di * dot(s.Gs + i * ld, 1, s.Gs + j * ld, n) * dj;
    if (i == j) v += 1.f - di;
    s.S[i * ldm + j] = v;
  }
  __syncthreads();
  float mx[1] = {-INFINITY};
  for (int i = threadIdx.x; i < m; i += K2_THREADS) mx[0] = nmax(mx[0], s.S[i * ldm + i]);
  block_reduce<1, true>(mx, s.red);
  const float reg = 1e-7f * nmax(mx[0], 1.f);
  for (int i = threadIdx.x; i < m; i += K2_THREADS) s.S[i * ldm + i] += reg;
  __syncthreads();
  chol_inplace(s.S, m, ldm);

  for (int i = threadIdx.x; i < n; i += K2_THREADS) s.r1[i] = -s.q[i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) s.r2[r] = s.dm[r] * s.bv[r];
  __syncthreads();
  kkt_solve(s, s.r1, s.r2, xp, s.lam);
  // one refinement pass through the same factors
  for (int r = threadIdx.x; r < m; r += K2_THREADS) s.w[r] = s.dm[r] * s.lam[r];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += K2_THREADS)
    s.r1[i] = -(s.q[i] + dot(s.P + i * ld, 1, xp, n) + dot(s.G + i, ld, s.w, m));
  for (int r = threadIdx.x; r < m; r += K2_THREADS)
    s.r2[r] = s.dm[r] * (s.bv[r] - dot(s.G + r * ld, 1, xp, n));
  __syncthreads();
  kkt_solve(s, s.r1, s.r2, s.dx, s.dl);
  for (int i = threadIdx.x; i < n; i += K2_THREADS) xp[i] += s.dx[i];
  for (int r = threadIdx.x; r < m; r += K2_THREADS) yp[r] = s.dm[r] * (s.lam[r] + s.dl[r]);
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

__global__ void __launch_bounds__(K2_THREADS, 2)
solve_polish_kernel(const float* __restrict__ Pg, const float* __restrict__ Gg,
                    const float* __restrict__ qg, const float* __restrict__ log_,
                    const float* __restrict__ hig, const float* __restrict__ xw,
                    const float* __restrict__ yw, const float* __restrict__ rho_w,
                    const K2Params p, float* __restrict__ x_out, float* __restrict__ y_out,
                    unsigned char* __restrict__ ok_out, float* __restrict__ prim_out,
                    float* __restrict__ dual_out, float* __restrict__ rho_out,
                    float* __restrict__ checks_out) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = p.n, m = p.m;
  Work s;
  s.n = n;
  s.m = m;
  s.ldn = n | 1;  // odd leading dimensions: conflict-free row and column walks
  s.ldm = m | 1;
  const int ld = s.ldn;
  extern __shared__ float sm[];
  float* cur = sm;
  auto take = [&](int count) {
    float* ptr = cur;
    cur += count;
    return ptr;
  };
  s.P = take(n * ld);
  s.G = take(m * ld);
  s.Ps = take(n * ld);
  s.Gs = take(m * ld);
  s.GtG = take(n * ld);
  s.M = take(n * ld);
  s.Y = take(n * ld);
  s.Mi = take(n * ld);
  s.S = take(m * s.ldm);
  float** nvec[] = {&s.q, &s.d, &s.qs, &s.x, &s.xt, &s.rhs, &s.Px, &s.tn,
                    &s.xp1, &s.xp2, &s.u, &s.pir, &s.dx, &s.r1, &s.gv};
  for (float** v : nvec) *v = take(n);
  float** mvec[] = {&s.lo, &s.hi, &s.e, &s.los, &s.his, &s.z, &s.y, &s.t, &s.Gx,
                    &s.yp1, &s.yp2, &s.dm, &s.bv, &s.w, &s.dl, &s.w2, &s.lam, &s.r2};
  for (float** v : mvec) *v = take(m);
  s.red = take(NWARPS * MAX_RED);

  // ---- load the scenario ----
  const float* Pb = Pg + (size_t)b * n * n;
  const float* Gb = Gg + (size_t)b * m * n;
  for (int e = tid; e < n * n; e += K2_THREADS) s.P[(e / n) * ld + e % n] = Pb[e];
  for (int e = tid; e < m * n; e += K2_THREADS) s.G[(e / n) * ld + e % n] = Gb[e];
  for (int i = tid; i < n; i += K2_THREADS) {
    s.q[i] = qg[(size_t)b * n + i];
    s.d[i] = 1.f;
  }
  for (int r = tid; r < m; r += K2_THREADS) {
    s.lo[r] = log_[(size_t)b * m + r];
    s.hi[r] = hig[(size_t)b * m + r];
    s.e[r] = 1.f;
  }
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
  for (int e = tid; e < n * n; e += K2_THREADS) {  // Gs'Gs, independent of rho
    const int i = e / n, j = e - i * n;
    if (j > i) continue;
    const float v = dot(s.Gs + i, ld, s.Gs + j, ld, m);
    s.GtG[i * ld + j] = v;
    s.GtG[j * ld + i] = v;
  }
  for (int r = tid; r < m; r += K2_THREADS)
    s.z[r] = clip(dot(s.Gs + r * ld, 1, s.x, n), s.los[r], s.his[r]);
  float mq[1] = {0.f};
  for (int i = tid; i < n; i += K2_THREADS) mq[0] = nmax(mq[0], fabsf(s.qs[i]));
  block_reduce<1, true>(mq, s.red);  // also orders the writes above
  const float max_qs = mq[0];

  // ---- adaptive ADMM ----
  const float rho_in = rho_w[b];
  float rho_f = rho_in, rho_p = rho_in, prev_score = 1e30f, prim = 0.f, dual = 0.f;
  float checks = 0.f;
  bool refac = true, conv = false;
  const float alpha = p.alpha, sigma = p.sigma;
  for (int k = 0; k < p.max_checks && !conv; ++k) {
    const float rho = refac ? rho_p : rho_f;
    if (refac) factorize(s, rho, sigma);
    checks += 1.f;
    for (int r = tid; r < m; r += K2_THREADS) s.t[r] = rho * s.z[r] - s.y[r];
    __syncthreads();
    for (int it = 0; it < p.check_iters; ++it) {
      for (int i = tid; i < n; i += K2_THREADS)
        s.rhs[i] = sigma * s.x[i] - s.qs[i] + dot(s.Gs + i, ld, s.t, m);
      __syncthreads();
      for (int i = tid; i < n; i += K2_THREADS) s.xt[i] = dot(s.Mi + i, ld, s.rhs, n);
      __syncthreads();
      for (int w = tid; w < m + n; w += K2_THREADS) {
        if (w < m) {
          const float gxt = dot(s.Gs + w * ld, 1, s.xt, n);
          const float zt = alpha * gxt + (1.f - alpha) * s.z[w];
          const float zn = clip(zt + s.y[w] / rho, s.los[w], s.his[w]);
          const float yn = s.y[w] + rho * (zt - zn);
          s.z[w] = zn;
          s.y[w] = yn;
          s.t[w] = rho * zn - yn;
        } else {
          const int i = w - m;
          s.x[i] = alpha * s.xt[i] + (1.f - alpha) * s.x[i];
        }
      }
      __syncthreads();
    }
    // residuals + OSQP rho rule
    float mx[4] = {0.f, 0.f, 0.f, 0.f};  // prim, max|Gx|, max|z|, dual
    float mp[1] = {0.f};                 // max|Px|
    for (int r = tid; r < m; r += K2_THREADS) {
      const float gx = dot(s.Gs + r * ld, 1, s.x, n);
      mx[0] = nmax(mx[0], fabsf(gx - s.z[r]));
      mx[1] = nmax(mx[1], fabsf(gx));
      mx[2] = nmax(mx[2], fabsf(s.z[r]));
    }
    for (int i = tid; i < n; i += K2_THREADS) {
      const float px = dot(s.Ps + i * ld, 1, s.x, n);
      mp[0] = nmax(mp[0], fabsf(px));
      mx[3] = nmax(mx[3], fabsf(px + s.qs[i] + dot(s.Gs + i, ld, s.y, m)));
    }
    block_reduce<4, true>(mx, s.red);
    block_reduce<1, true>(mp, s.red);
    prim = mx[0];
    dual = mx[3];
    const float prim_rel = prim / nmax(nmax(mx[1], mx[2]), 1e-6f);
    const float dual_rel = dual / nmax(nmax(mp[0], max_qs), 1e-6f);
    const float rho_n = clip(rho * sqrtf((prim_rel + 1e-12f) / (dual_rel + 1e-12f)), 1e-6f, 1e6f);
    rho_f = rho;
    rho_p = rho_n;
    const float score = nmax(prim_rel, dual_rel);
    if (p.eps > 0.f) {
      conv = prim_rel <= p.eps && dual_rel <= p.eps;
      if (p.stall_cap > 0.f)
        conv = conv || (score <= p.stall_cap && score > p.stall_ratio * prev_score &&
                        prim <= p.stall_prim_cap);
    }
    prev_score = score;
    if (p.band > 1.f) {
      const float ratio = rho_n / rho;
      refac = (ratio > p.band || ratio * p.band < 1.f) && !conv;
    } else {
      refac = !conv;
    }
  }

  // ---- unscale: x and y of the original problem ----
  for (int i = tid; i < n; i += K2_THREADS) s.x[i] = s.d[i] * s.x[i];
  for (int r = tid; r < m; r += K2_THREADS) s.y[r] = (s.e[r] * s.y[r]) / c;
  __syncthreads();

  // ---- polish: factor P once (Lp in M, Y = Lp^-1), Vt = G Y' in Gs ----
  for (int e = tid; e < n * n; e += K2_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j <= i) s.M[i * ld + j] = s.P[i * ld + j];
  }
  __syncthreads();
  chol_inplace(s.M, n, ld);
  tri_inverse(s.M, s.Y, n, ld);
  for (int e = tid; e < m * n; e += K2_THREADS) {
    const int r = e / n, kk = e - r * n;
    s.Gs[r * ld + kk] = dot(s.Y + kk * ld, 1, s.G + r * ld, kk + 1);
  }
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
    dual_out[b] = dual;
    rho_out[b] = rho_f;
    checks_out[b] = checks;
  }
}

size_t k2_smem_bytes(int n, int m) {
  const size_t ldn = n | 1, ldm = m | 1;
  const size_t floats = 6 * n * ldn + 2 * m * ldn + m * ldm + 15 * (size_t)n +
                        18 * (size_t)m + NWARPS * MAX_RED;
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// Shapes: P (B,n,n), G (B,m,n), q (B,n), lo/hi (B,m), warm x (B,n), y (B,m),
// rho (B,); outputs x (B,n), y (B,m), ok (B,) bool, prim/dual/rho/checks
// (B,); all float32 unless noted, contiguous, on the device. `iparams` is
// a host array {ruiz_iters, max_checks, check_iters}; `fparams` a host
// array {sigma, alpha, eps, band, stall_cap, stall_ratio, stall_prim_cap,
// act_tol_rel}. Returns the CUDA error code of the launch (0 = launched).
int k2_solve_polish(const float* P, const float* G, const float* q, const float* lo,
                    const float* hi, const float* xw, const float* yw, const float* rho_w,
                    int B, int n, int m, const int* iparams, const float* fparams,
                    float* x, float* y, unsigned char* ok, float* prim, float* dual,
                    float* rho, float* checks, void* stream) {
  if (B <= 0) return 0;
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
  const size_t smem = k2_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      solve_polish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_polish_kernel<<<B, K2_THREADS, smem, (cudaStream_t)stream>>>(
      P, G, q, lo, hi, xw, yw, rho_w, p, x, y, ok, prim, dual, rho, checks);
  return (int)cudaGetLastError();
}

}  // extern "C"
