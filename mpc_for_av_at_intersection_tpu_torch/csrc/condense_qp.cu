// K1: fused rollout + linearization + condensing of the tracking QP.
//
// Replaces the TPU kernel mpc_for_av_at_intersection_tpu/ops/condense_pallas.py
// (build_qp_pallas -> _kernel) for the canonical 4-state controller and, as
// the JERK instantiation, for the jerk variant (jerk=True there). Plain
// version: ops/condense_qp.py::build_qp_reference (plant_rollout ->
// linearize_bicycle -> condense, or condense_jerk).
//
// Per scenario: roll the plant along the previous controls (the operating
// point), linearize the bicycle there at deltabar = 0 (A_t has six
// non-identity entries, B_t two), and condense X = F u + g into
//   P = 2 (sum_t F_t' Q_t F_t + R + Rd),  q = 2 sum_t F_t' Q_t (g_t - r_t),
//   G = [velocity rows of F; accel box; steer box; steer-rate rows], lo, hi.
//
// Jerk variant (JERK): the state gains an accel x4 (v_{t+1} = v_t + dt (x4_t
// + u0_t), x4_{t+1} = x4_t + dt u0_t) and the decision vector a free a0,
// column n-1 = 2T. Column j's x4 row starts as the a0 indicator and feeds
// v; x4's affine part stays 0 and its tracking weight is 0, so only F, g
// (written at stride 5) and the static jerk diagonal jerk_w dt^2 on u0_0 ..
// u0_{T-2} change; the input and rate costs and the box rows skip a0.
//
// Design: one CTA of 128 threads per scenario, three phases.
//  1. Warp 0 rolls the plant out. Only the multiply-adds of v, yaw and the
//     affine x, y stay on lane 0's serial chains, which read their inputs
//     a few steps ahead of their stores; tanf of each clamped steer, v_t / L
//     times it, cosf/sinf of each operating yaw and the products that scale
//     gv, gw and yaw in the x, y recurrences run on all lanes between the
//     chains. Every value keeps the expression it had on one serial
//     thread. Warps 1-3 meanwhile compute the per-slot tracking weights and
//     write G's static rows (accel box, steer box, steer-rate rows) row by
//     row, and their bounds.
//  2. Thread j runs column j's T-step recurrence of F and keeps the
//     tracked rows (4T rows of stride S, n rounded up to a multiple of 4 so
//     that every 4-column group is one 16-byte load) in shared memory; the
//     threads from the top compute the gradient weights of each slot.
//  3. P's lower triangle in 2x4 register tiles, one tile a thread (110 at
//     n = 40, so all four warps share them): per slot a tile reads its two
//     rows' x, y, v, yaw as 8-byte loads, its four columns' as 16-byte
//     loads and the slot's five weights once, and updates its 8 entries,
//     each with one entry's arithmetic of the one-entry-a-thread version
//     (slot_term), t ascending, so every output is that version's bit for
//     bit. Each lower entry is computed once and mirrored, so P is exactly
//     symmetric. q (one column a thread, from the top) beside it. P leaves
//     through shared memory as one contiguous store.
// The launch geometry (S and the shared-memory size) comes from the
// wrapper, ops/condense_qp.py::k1_launch; the CPU tests hold the tiles
// (tile_of) to covering every lower entry of P once inside the stride.
//
// What bounds it on an H100 (chip_smoke.py --k1k4-times): latency, not its
// stores. The outputs are ~8.2k floats a scenario (~134 MB at B=4096,
// T=20, 0.041 ms at full HBM rate). The one-entry-a-thread version wrote
// them at 0.4 TB/s: each CTA lived ~66k cycles, 40% of it behind thread 0's
// rollout (accurate cosf/sinf/tanf and a division on the chain) and 47% in
// P's sums (13 shared loads a term). This one lives ~46k cycles, but 9 CTAs
// fit an SM (56 registers): ~0.1 ms, ~1.4 TB/s. What is left is the
// rollout's chains and F's column recurrences (a third of a CTA each) and
// the tiles' slot loop, at about half the SM's issue rate.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int K1_THREADS = 128;
constexpr int K1_TILE = 4;  // columns of a register tile of P (it has 2 rows)

struct K1Consts {
  float dt, L, w_perp, w_para, q_v, q_yaw;
  float qf[4];  // terminal weights, already multiplied by T
  float end_w, r_accel, r_steer, rd_accel, rd_steer;
  float min_speed, max_speed, max_decel, max_accel, max_steer, rate_lim;
  float jerk_w;  // jerk penalty weight (JERK only)
};

constexpr int K1_NCONSTS = sizeof(K1Consts) / sizeof(float);

// floats of shared memory: F's tracked rows 4T x S, the per-slot arrays
// (20 floats a slot, and three of T rounded up to a multiple of 4), P n x n
// last
__host__ __device__ inline int k1_smem_floats(int T, int n, int S) {
  return 4 * T * S + 20 * T + 3 * ((T + 3) & ~3) + n * n;
}

// tile k of P's lower triangle, 2 rows x 4 columns: rows 2I, 2I+1 and
// columns 4J..4J+3, J = 0..I/2, row-major: (0,0), (1,0), (2,0), (2,1), ...
__device__ inline void tile_of(int k, int& I, int& J) {
  I = 0;
  J = k;
  while (J > I / 2) {
    J -= I / 2 + 1;
    ++I;
  }
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// One slot's term of a P entry, w0 xi xj + w1 (xi yj + yi xj) + w2 yi yj +
// w3 vi vj + w4 wi wj, with the roundings and fused multiply-adds that the
// compiler chose for this expression in the one-entry-a-thread version of
// the kernel (its SASS), spelled out so that a tile's code, where the
// compiler may fuse the other product of the cross term, rounds alike.
__device__ inline float slot_term(float4 w, float w4, float xi, float xj, float yi, float yj,
                                  float vi, float vj, float wi, float wj) {
  const float cross = __fmaf_rn(yi, xj, __fmul_rn(xi, yj));
  float s = __fmaf_rn(__fmul_rn(w.x, xi), xj, __fmul_rn(w.y, cross));
  s = __fmaf_rn(__fmul_rn(w.z, yi), yj, s);
  s = __fmaf_rn(__fmul_rn(w.w, vi), vj, s);
  return __fmaf_rn(__fmul_rn(w4, wi), wj, s);
}

template <bool JERK>
__global__ void __launch_bounds__(K1_THREADS)
build_qp_kernel(const float* __restrict__ state, const float* __restrict__ oa,
                const float* __restrict__ od, const float* __restrict__ xref,
                const unsigned char* __restrict__ reaches_end, const int T, const int S,
                const K1Consts k, float* __restrict__ P, float* __restrict__ q,
                float* __restrict__ G, float* __restrict__ lo, float* __restrict__ hi,
                float* __restrict__ F, float* __restrict__ g) {
  constexpr int NX = JERK ? 5 : 4;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ub = 2 * T, n = ub + (JERK ? 1 : 0), m = 4 * T - 1, T1 = T + 1;

  extern __shared__ float4 sm4[];
  float* sF = reinterpret_cast<float*>(sm4);  // 4T x S: rows x, y, v, yaw of state t+1
  float* sW = sF + 4 * T * S;   // 8T: tracking weights qxx, qxy, qyy, qvv, qww (+3 pad)
  float* sCS = sW + 8 * T;      // 4T: cos, sin of the operating yaw, operating speed, yaw
  float* sA = sCS + 4 * T;      // 4T: gradient weights Q_t (g_t - r_t)
  float* sB = sA + 4 * T;       // 4T: dt c, dt s, dt vb s, dt vb c
  const int T4 = (T + 3) & ~3;
  float* sGx = sB + 4 * T;      // T: affine x of state t+1 (oa during the rollout)
  float* sGy = sGx + T4;        // T: affine y of state t+1
  float* sU = sGy + T4;         // T: tan of the clamped steer, then (v / L) tan
  float* sP = sU + T4;          // n x n

  const float* st = state + (size_t)b * 4;
  const float* xr_b = xref + (size_t)b * 4 * T1;
  const unsigned char* re_b = reaches_end + (size_t)b * T1;
  const float gv = st[2], gw = st[3];  // velocity/yaw rows of g stay constant
  float* G_b = G + (size_t)b * m * n;

  // Phase 1: the plant rollout (warp 0) beside the tracking weights and
  // G's static rows (warps 1-3).
  if (warp == 0) {
    for (int t = lane; t < T; t += 32) {
      const float delta = fminf(fmaxf(od[(size_t)b * T + t], -k.max_steer), k.max_steer);
      sU[t] = tanf(delta);
      sGx[t] = oa[(size_t)b * T + t];
    }
    __syncwarp();
    // lane 0's chains read four steps' inputs ahead of the stores they
    // would otherwise wait behind
    if (lane == 0) {  // speed: the clamped step, with the pre-update speed kept
      float v = st[2];
      float4 next = ld4(sGx);
      for (int t0 = 0; t0 < T; t0 += 4) {
        const float a[4] = {next.x, next.y, next.z, next.w};
        if (t0 + 4 < T) next = ld4(sGx + t0 + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (t0 + i < T) {
            sCS[4 * (t0 + i) + 2] = v;
            v = fminf(fmaxf(v + a[i] * k.dt, k.min_speed), k.max_speed);
          }
        }
      }
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) sU[t] = (sCS[4 * t + 2] / k.L) * sU[t];
    __syncwarp();
    if (lane == 0) {  // yaw with the pre-update speed
      float yaw = st[3];
      float4 next = ld4(sU);
      for (int t0 = 0; t0 < T; t0 += 4) {
        const float u[4] = {next.x, next.y, next.z, next.w};
        if (t0 + 4 < T) next = ld4(sU + t0 + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (t0 + i < T) {
            sCS[4 * (t0 + i) + 3] = yaw;
            yaw = yaw + u[i] * k.dt;
          }
        }
      }
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) {
      const float yaw = sCS[4 * t + 3], vb = sCS[4 * t + 2];
      const float c = cosf(yaw), s = sinf(yaw);
      sCS[4 * t] = c;
      sCS[4 * t + 1] = s;
      sB[4 * t] = k.dt * c;
      sB[4 * t + 1] = k.dt * s;
      sB[4 * t + 2] = k.dt * vb * s;
      sB[4 * t + 3] = k.dt * vb * c;
    }
    __syncwarp();
    if (lane == 0) {  // affine x, y of each state
      float gx = st[0], gy = st[1];
      float4 p_next = ld4(sB);
      float phib_next = sCS[3];
      for (int t = 0; t < T; ++t) {
        const float4 p = p_next;
        const float phib = phib_next;
        if (t + 1 < T) {
          p_next = ld4(sB + 4 * (t + 1));
          phib_next = sCS[4 * (t + 1) + 3];
        }
        const float gx_n = gx + p.x * gv - p.z * gw + p.z * phib;
        const float gy_n = gy + p.y * gv + p.w * gw - p.w * phib;
        gx = gx_n;
        gy = gy_n;
        sGx[t] = gx;
        sGy[t] = gy;
      }
    }
  } else {
    for (int t = tid - 32; t < T; t += K1_THREADS - 32) {
      const bool end = re_b[t + 1] != 0;
      const float ryaw = xr_b[3 * T1 + t + 1];
      const float c = cosf(ryaw), s = sinf(ryaw);
      float* w = sW + 8 * t;
      w[0] = end ? k.qf[0] : k.w_perp * s * s + k.w_para * c * c;
      w[1] = end ? 0.f : (-k.w_perp + k.w_para) * c * s;
      w[2] = end ? k.qf[1] : k.w_perp * c * c + k.w_para * s * s;
      w[3] = end ? k.qf[2] : k.q_v;
      w[4] = end ? k.qf[3] : k.q_yaw;
    }
    // rows T..m-1 of G, one row a pass: accel box (+1 at col 2r), steer
    // box (+1 at col 2r+1), steer-rate differences (-1 at 2j+1, +1 at 2j+3)
    for (int r = warp - 1; r < m - T; r += K1_THREADS / 32 - 1) {
      int c1, c2 = -1;
      float v1, v2 = 0.f;
      if (r < T) {
        c1 = 2 * r;
        v1 = 1.f;
      } else if (r < 2 * T) {
        c1 = 2 * (r - T) + 1;
        v1 = 1.f;
      } else {
        c1 = 2 * (r - 2 * T) + 1;
        v1 = -1.f;
        c2 = c1 + 2;
        v2 = 1.f;
      }
      float* row = G_b + (size_t)(T + r) * n;
      for (int c = lane; c < n; c += 32) row[c] = c == c1 ? v1 : (c == c2 ? v2 : 0.f);
    }
    for (int r = tid - 32; r < m - T; r += K1_THREADS - 32) {
      const float l = r < T ? k.max_decel : (r < 2 * T ? -k.max_steer : -k.rate_lim);
      const float h = r < T ? k.max_accel : (r < 2 * T ? k.max_steer : k.rate_lim);
      lo[(size_t)b * m + T + r] = l;
      hi[(size_t)b * m + T + r] = h;
    }
  }
  __syncthreads();

  // Phase 2: column recurrences of F (thread j owns column j; the pad
  // columns n..S-1 are zero), and the gradient weights of each slot on the
  // threads from the top.
  float* F_b = F + (size_t)b * NX * T * n;
  for (int j = tid; j < S; j += K1_THREADS) {
    if (j >= n) {
      for (int r = 0; r < 4 * T; ++r) sF[r * S + j] = 0.f;
      continue;
    }
    float xr = 0.f, yr = 0.f, vr = 0.f, wr = 0.f;
    float ar = (JERK && j == ub) ? 1.f : 0.f;  // x4 row: the a0 indicator
    float4 cs_next = ld4(sCS);
    for (int t = 0; t < T; ++t) {
      const float4 cs = cs_next;  // read ahead of this step's stores
      if (t + 1 < T) cs_next = ld4(sCS + 4 * (t + 1));
      const float c = cs.x, s = cs.y, vb = cs.z;
      const float xr_n = xr + k.dt * c * vr - k.dt * (vb * s) * wr;
      const float yr_n = yr + k.dt * s * vr + k.dt * (vb * c) * wr;
      if (j == 2 * t) vr = vr + k.dt;
      if constexpr (JERK) {
        vr = vr + k.dt * ar;  // the pre-update accel state
        if (j == 2 * t) ar = ar + k.dt;
      }
      if (j == 2 * t + 1) wr = wr + (k.dt / k.L) * vb;
      xr = xr_n;
      yr = yr_n;
      float* row = sF + 4 * t * S;
      row[j] = xr;
      row[S + j] = yr;
      row[2 * S + j] = vr;
      row[3 * S + j] = wr;
      float* grow = F_b + (size_t)NX * t * n;
      grow[j] = xr;
      grow[n + j] = yr;
      grow[2 * n + j] = vr;
      grow[3 * n + j] = wr;
      if constexpr (JERK) grow[4 * n + j] = ar;
      G_b[(size_t)t * n + j] = vr;  // velocity constraint row t
    }
  }
  for (int t = K1_THREADS - 1 - tid; t < T; t += K1_THREADS) {
    const float* w = sW + 8 * t;
    const float dx = sGx[t] - xr_b[t + 1];
    const float dy = sGy[t] - xr_b[T1 + t + 1];
    const float dv = gv - xr_b[2 * T1 + t + 1];
    const float dw = gw - xr_b[3 * T1 + t + 1];
    sA[4 * t] = w[0] * dx + w[1] * dy;
    sA[4 * t + 1] = w[1] * dx + w[2] * dy;
    sA[4 * t + 2] = w[3] * dv;
    sA[4 * t + 3] = w[4] * dw;
    float* g_b = g + ((size_t)b * T + t) * NX;
    g_b[0] = sGx[t];
    g_b[1] = sGy[t];
    g_b[2] = gv;
    g_b[3] = gw;
    if constexpr (JERK) g_b[4] = 0.f;
    lo[(size_t)b * m + t] = k.min_speed - gv;
    hi[(size_t)b * m + t] = k.max_speed - gv;
  }
  __syncthreads();

  // Phase 3: P's lower triangle in 2x4 register tiles (mirrored), and q on
  // the threads from the top.
  const int nr = (n + 1) / 2, h = nr / 2;
  const int n_tiles = (nr % 2) ? (h + 1) * (h + 1) : h * (h + 1);
  for (int tile = tid; tile < n_tiles; tile += K1_THREADS) {
    int I, J;
    tile_of(tile, I, J);
    const int i0 = 2 * I, j0 = K1_TILE * J;
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* Ft = sF + 4 * t * S;
      const float2 xi2 = ld2(Ft + i0), yi2 = ld2(Ft + S + i0);
      const float2 vi2 = ld2(Ft + 2 * S + i0), wi2 = ld2(Ft + 3 * S + i0);
      const float4 xj4 = ld4(Ft + j0), yj4 = ld4(Ft + S + j0);
      const float4 vj4 = ld4(Ft + 2 * S + j0), wj4 = ld4(Ft + 3 * S + j0);
      const float4 w = ld4(sW + 8 * t);
      const float w4 = sW[8 * t + 4];
      const float xi[2] = {xi2.x, xi2.y}, yi[2] = {yi2.x, yi2.y};
      const float vi[2] = {vi2.x, vi2.y}, wi[2] = {wi2.x, wi2.y};
      const float xj[4] = {xj4.x, xj4.y, xj4.z, xj4.w}, yj[4] = {yj4.x, yj4.y, yj4.z, yj4.w};
      const float vj[4] = {vj4.x, vj4.y, vj4.z, vj4.w}, wj[4] = {wj4.x, wj4.y, wj4.z, wj4.w};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[a][c] = __fadd_rn(acc[a][c], slot_term(w, w4, xi[a], xj[c], yi[a], yj[c], vi[a],
                                                      vj[c], wi[a], wj[c]));
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + a, j = j0 + c;
        if (i >= n || j > i) continue;
        float v = acc[a][c];
        // input cost (end-switched on reaches_end[0..T-1]) and input-rate
        // cost, on the inputs (i < ub) only
        const float rd = (i % 2 == 0) ? k.rd_accel : k.rd_steer;
        if (i == j && i < ub) {
          const bool end = re_b[i / 2] != 0;
          v += end ? k.end_w : ((i % 2 == 0) ? k.r_accel : k.r_steer);
          float rate = (i <= ub - 3 ? rd : 0.f) + (i >= 2 ? rd : 0.f);
          // the jerk penalty sum_{t < T-1} (x4_{t+1} - x4_t)^2 = dt^2 u0_t^2
          if constexpr (JERK) rate += (i <= ub - 4 && i % 2 == 0) ? k.jerk_w * k.dt * k.dt : 0.f;
          v += rate;
        } else if (i - j == 2 && i < ub) {
          v += -rd;
        }
        sP[i * n + j] = 2.f * v;
        sP[j * n + i] = 2.f * v;
      }
    }
  }
  for (int i = K1_THREADS - 1 - tid; i < n; i += K1_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* Ft = sF + 4 * t * S;
      const float4 a = ld4(sA + 4 * t);
      acc += Ft[i] * a.x + Ft[S + i] * a.y + Ft[2 * S + i] * a.z + Ft[3 * S + i] * a.w;
    }
    q[(size_t)b * n + i] = 2.f * acc;
  }
  __syncthreads();
  float* P_b = P + (size_t)b * n * n;
  if ((n * n) % 4 == 0) {
    for (int e = tid; e < n * n / 4; e += K1_THREADS)
      reinterpret_cast<float4*>(P_b)[e] = reinterpret_cast<const float4*>(sP)[e];
  } else {
    for (int e = tid; e < n * n; e += K1_THREADS) P_b[e] = sP[e];
  }
}

template <bool JERK>
int blocks_per_sm(int smem) {
  int blocks = 0;
  auto kernel = build_qp_kernel<JERK>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, K1_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" {

int k1_num_consts() { return K1_NCONSTS; }

// Shapes: state (B,4), oa/od (B,T), xref (B,4,T+1), reaches_end (B,T+1)
// bool; outputs P (B,n,n), q (B,n), G (B,m,n), lo/hi (B,m), F (B,nx*T,n),
// g (B,nx*T) with m = 4T-1 and n = 2T, nx = 4 (jerk = 0) or n = 2T+1,
// nx = 5 (jerk = 1); all float32, contiguous, on the device. `consts` is a
// host array of k1_num_consts() floats in K1Consts order. `stride` is the
// shared-memory row stride of F (>= n, a multiple of 4) and `smem` the
// dynamic shared memory in bytes, both from the wrapper's launch geometry.
// Returns the CUDA error code of the launch (0 = launched).
int k1_build_qp(const float* state, const float* oa, const float* od, const float* xref,
                const unsigned char* reaches_end, int B, int T, int jerk, const float* consts,
                float* P, float* q, float* G, float* lo, float* hi, float* F, float* g,
                int stride, int smem, void* stream) {
  if (B <= 0) return 0;
  const int n = 2 * T + (jerk ? 1 : 0);
  if (T <= 0 || stride < n || stride % K1_TILE != 0 ||
      (size_t)smem < sizeof(float) * (size_t)k1_smem_floats(T, n, stride))
    return (int)cudaErrorInvalidValue;
  K1Consts k;
  memcpy(&k, consts, sizeof(K1Consts));
  auto kernel = jerk ? build_qp_kernel<true> : build_qp_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, K1_THREADS, smem, (cudaStream_t)stream>>>(state, oa, od, xref, reaches_end, T,
                                                        stride, k, P, q, G, lo, hi, F, g);
  return (int)cudaGetLastError();
}

// CTAs of the K1 kernel (jerk = 0 or 1) that fit one SM at `smem` bytes
// of dynamic shared memory, as the CUDA runtime counts them from registers
// and shared memory; a negative CUDA error code on failure.
int k1_blocks_per_sm(int jerk, int smem) {
  return jerk ? blocks_per_sm<true>(smem) : blocks_per_sm<false>(smem);
}

}  // extern "C"
