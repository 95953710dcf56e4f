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
// Design: one CTA per scenario. The plant rollout is a serial T-step chain
// (thread 0). Each column j of F follows its own T-step recurrence, so
// thread j runs it and keeps the tracked rows of F (4T x n floats) in
// shared memory; P is then a sum of T rank-1 terms per entry, computed once
// per lower-triangle entry and mirrored, so P comes out exactly symmetric.
//
// What bounds it on an H100: stores. The outputs are ~8.2k floats per
// scenario at T = 20 (P 1600, G 3160, F 3200, ...): ~135 MB per tick at
// B = 4096 (jerk: ~9.2k floats, ~151 MB), against ~0.1 MFLOP of arithmetic
// per scenario. Every output row
// is written by consecutive threads (coalesced) and nothing is re-read from
// device memory. Later work: skip writing G's static rows and F where the
// consumer does not need them.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int K1_THREADS = 256;

struct K1Consts {
  float dt, L, w_perp, w_para, q_v, q_yaw;
  float qf[4];  // terminal weights, already multiplied by T
  float end_w, r_accel, r_steer, rd_accel, rd_steer;
  float min_speed, max_speed, max_decel, max_accel, max_steer, rate_lim;
  float jerk_w;  // jerk penalty weight (JERK only)
};

constexpr int K1_NCONSTS = sizeof(K1Consts) / sizeof(float);

template <bool JERK>
__global__ void __launch_bounds__(K1_THREADS)
build_qp_kernel(const float* __restrict__ state, const float* __restrict__ oa,
                const float* __restrict__ od, const float* __restrict__ xref,
                const unsigned char* __restrict__ reaches_end, const int T,
                const K1Consts k, float* __restrict__ P, float* __restrict__ q,
                float* __restrict__ G, float* __restrict__ lo, float* __restrict__ hi,
                float* __restrict__ F, float* __restrict__ g) {
  constexpr int NX = JERK ? 5 : 4;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int ub = 2 * T, n = ub + (JERK ? 1 : 0), m = 4 * T - 1, R = 4 * T, T1 = T + 1;

  extern __shared__ float sm[];
  float* sF = sm;              // R x n: rows x, y, v, yaw of state t+1
  float* sP = sF + R * n;      // n x n
  float* sVb = sP + n * n;     // T operating speed
  float* sC = sVb + T;         // T cos(operating yaw)
  float* sS = sC + T;          // T sin(operating yaw)
  float* sGx = sS + T;         // T affine x of state t+1
  float* sGy = sGx + T;        // T affine y of state t+1
  float* sW = sGy + T;         // 5T tracking weights qxx, qxy, qyy, qvv, qww
  float* sA = sW + 5 * T;      // 4T gradient weights Q_t (g_t - r_t)

  const float* st = state + (size_t)b * 4;
  const float* xr_b = xref + (size_t)b * 4 * T1;
  const unsigned char* re_b = reaches_end + (size_t)b * T1;
  const float gv = st[2], gw = st[3];  // velocity/yaw rows of g stay constant

  // Phase 1: the serial plant rollout (thread 0) beside the per-slot
  // tracking weights (warps 1..7).
  if (tid == 0) {
    float v = st[2], yaw = st[3], gx = st[0], gy = st[1];
    for (int t = 0; t < T; ++t) {
      const float vb = v, c = cosf(yaw), s = sinf(yaw), phib = yaw;
      sVb[t] = vb;
      sC[t] = c;
      sS[t] = s;
      const float gx_n = gx + k.dt * c * gv - k.dt * vb * s * gw + k.dt * vb * s * phib;
      const float gy_n = gy + k.dt * s * gv + k.dt * vb * c * gw - k.dt * vb * c * phib;
      gx = gx_n;
      gy = gy_n;
      sGx[t] = gx;
      sGy[t] = gy;
      // plant step: pose with the pre-update speed, then the clamped speed
      const float delta = fminf(fmaxf(od[(size_t)b * T + t], -k.max_steer), k.max_steer);
      yaw = yaw + (v / k.L) * tanf(delta) * k.dt;
      v = fminf(fmaxf(v + oa[(size_t)b * T + t] * k.dt, k.min_speed), k.max_speed);
    }
  }
  for (int t = tid - 32; t >= 0 && t < T; t += K1_THREADS - 32) {
    const bool end = re_b[t + 1] != 0;
    const float ryaw = xr_b[3 * T1 + t + 1];
    const float c = cosf(ryaw), s = sinf(ryaw);
    float* w = sW + 5 * t;
    w[0] = end ? k.qf[0] : k.w_perp * s * s + k.w_para * c * c;
    w[1] = end ? 0.f : (-k.w_perp + k.w_para) * c * s;
    w[2] = end ? k.qf[1] : k.w_perp * c * c + k.w_para * s * s;
    w[3] = end ? k.qf[2] : k.q_v;
    w[4] = end ? k.qf[3] : k.q_yaw;
  }
  __syncthreads();

  // Phase 2: column recurrences of F (thread j owns column j), and the
  // gradient weights of each slot.
  float* F_b = F + (size_t)b * NX * T * n;
  float* G_b = G + (size_t)b * m * n;
  for (int j = tid; j < n; j += K1_THREADS) {
    float xr = 0.f, yr = 0.f, vr = 0.f, wr = 0.f;
    float ar = (JERK && j == ub) ? 1.f : 0.f;  // x4 row: the a0 indicator
    for (int t = 0; t < T; ++t) {
      const float c = sC[t], s = sS[t], vb = sVb[t];
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
      float* row = sF + 4 * t * n;
      row[j] = xr;
      row[n + j] = yr;
      row[2 * n + j] = vr;
      row[3 * n + j] = wr;
      float* grow = F_b + (size_t)NX * t * n;
      grow[j] = xr;
      grow[n + j] = yr;
      grow[2 * n + j] = vr;
      grow[3 * n + j] = wr;
      if constexpr (JERK) grow[4 * n + j] = ar;
      G_b[(size_t)t * n + j] = vr;  // velocity constraint row t
    }
  }
  for (int t = tid; t < T; t += K1_THREADS) {
    const float* w = sW + 5 * t;
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

  // Phase 3: P (lower triangle, mirrored), q, and the static rows.
  for (int e = tid; e < n * n; e += K1_THREADS) {
    const int i = e / n, j = e - i * n;
    if (j > i) continue;
    float acc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* Ft = sF + 4 * t * n;
      const float* w = sW + 5 * t;
      const float xi = Ft[i], xj = Ft[j], yi = Ft[n + i], yj = Ft[n + j];
      acc += w[0] * xi * xj + w[1] * (xi * yj + yi * xj) + w[2] * yi * yj +
             w[3] * Ft[2 * n + i] * Ft[2 * n + j] + w[4] * Ft[3 * n + i] * Ft[3 * n + j];
    }
    // input cost (end-switched on reaches_end[0..T-1]) and input-rate
    // cost, on the inputs (i < ub) only
    const float rd = (i % 2 == 0) ? k.rd_accel : k.rd_steer;
    if (i == j && i < ub) {
      const bool end = re_b[i / 2] != 0;
      acc += end ? k.end_w : ((i % 2 == 0) ? k.r_accel : k.r_steer);
      float rate = (i <= ub - 3 ? rd : 0.f) + (i >= 2 ? rd : 0.f);
      // the jerk penalty sum_{t < T-1} (x4_{t+1} - x4_t)^2 = dt^2 u0_t^2
      if constexpr (JERK) rate += (i <= ub - 4 && i % 2 == 0) ? k.jerk_w * k.dt * k.dt : 0.f;
      acc += rate;
    } else if (i - j == 2 && i < ub) {
      acc += -rd;
    }
    sP[i * n + j] = 2.f * acc;
    sP[j * n + i] = 2.f * acc;
  }
  for (int i = tid; i < n; i += K1_THREADS) {
    float acc = 0.f;
    for (int t = 0; t < T; ++t) {
      const float* Ft = sF + 4 * t * n;
      const float* a = sA + 4 * t;
      acc += Ft[i] * a[0] + Ft[n + i] * a[1] + Ft[2 * n + i] * a[2] + Ft[3 * n + i] * a[3];
    }
    q[(size_t)b * n + i] = 2.f * acc;
  }
  // rows T..m-1: accel box (col 2r), steer box (col 2r+1), steer-rate
  // differences (-1 at col 2j+1, +1 at col 2j+3)
  for (int e = tid; e < (m - T) * n; e += K1_THREADS) {
    const int r = e / n, c = e - r * n;
    float v = 0.f;
    if (r < T) {
      v = (c == 2 * r) ? 1.f : 0.f;
    } else if (r < 2 * T) {
      v = (c == 2 * (r - T) + 1) ? 1.f : 0.f;
    } else {
      const int jr = r - 2 * T;
      v = (c == 2 * jr + 1) ? -1.f : ((c == 2 * jr + 3) ? 1.f : 0.f);
    }
    G_b[(size_t)(T + r) * n + c] = v;
  }
  for (int r = tid; r < m - T; r += K1_THREADS) {
    const float l = r < T ? k.max_decel : (r < 2 * T ? -k.max_steer : -k.rate_lim);
    const float h = r < T ? k.max_accel : (r < 2 * T ? k.max_steer : k.rate_lim);
    lo[(size_t)b * m + T + r] = l;
    hi[(size_t)b * m + T + r] = h;
  }
  __syncthreads();
  float* P_b = P + (size_t)b * n * n;
  for (int e = tid; e < n * n; e += K1_THREADS) P_b[e] = sP[e];
}

}  // namespace

extern "C" {

int k1_num_consts() { return K1_NCONSTS; }

// Shapes: state (B,4), oa/od (B,T), xref (B,4,T+1), reaches_end (B,T+1)
// bool; outputs P (B,n,n), q (B,n), G (B,m,n), lo/hi (B,m), F (B,nx*T,n),
// g (B,nx*T) with m = 4T-1 and n = 2T, nx = 4 (jerk = 0) or n = 2T+1,
// nx = 5 (jerk = 1); all float32, contiguous, on the device. `consts` is a
// host array of k1_num_consts() floats in K1Consts order. Returns the CUDA
// error code of the launch (0 = launched).
int k1_build_qp(const float* state, const float* oa, const float* od, const float* xref,
                const unsigned char* reaches_end, int B, int T, int jerk, const float* consts,
                float* P, float* q, float* G, float* lo, float* hi, float* F, float* g,
                void* stream) {
  if (B <= 0) return 0;
  K1Consts k;
  memcpy(&k, consts, sizeof(K1Consts));
  const int n = 2 * T + (jerk ? 1 : 0);
  const size_t smem = sizeof(float) * ((size_t)4 * T * n + (size_t)n * n + 14 * (size_t)T);
  auto kernel = jerk ? build_qp_kernel<true> : build_qp_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, K1_THREADS, smem, (cudaStream_t)stream>>>(state, oa, od, xref, reaches_end, T, k,
                                                        P, q, G, lo, hi, F, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
