// K4: the beam planner's frontier x primitive collision test.
//
// Replaces the TPU kernel mpc_for_av_at_intersection_tpu/ops/collision_pallas.py
// (frontier_collision -> _kernel). Plain version:
// ops/collision.py::frontier_collision_reference.
//
// For scenario b, frontier pose f and primitive p: out[b, f, p] is true when
// some live collision point of p, placed at pose f, lies inside some live
// obstacle, i.e. every one of the obstacle's 8 half-plane rows (a, b, c)
// gives (a*x + b*y) + c <= 0. A point is placed as (x + cos*px) - sin*py,
// (y + sin*px) + cos*py with the cosine and sine the wrapper computed in
// torch. This file is compiled with --fmad=false, so each multiply and add
// rounds on its own, as the plain version's tensor operations do, and a
// point on an obstacle's boundary falls on the same side in both.
//
// Design: one CTA of 256 threads per (scenario, block of 8 frontier rows);
// a launch covers the whole batch (one launch per beam iteration). The
// scenario's half-planes, the list of its live obstacles and the collision
// points sit in shared memory. One thread per (f, point): it places the
// point, walks the live obstacles, leaves an obstacle at its first violated
// row and stops at its first obstacle hit; a hit sets the (f, p) flag in
// shared memory, and the block writes its 8 x P flags once. The TPU kernel
// kept the (rows, points) violation tensor in VMEM and grouped points into
// primitives with an MXU product; neither is needed here.
//
// What bounds it on an H100: operations, the row tests (4 flops each) and
// the point placements; the bytes moved are the poses, the half-planes and
// the (B, F, P) flags, a few MB at the beam's width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K4_THREADS = 256;
constexpr int K4_ROWS = 8;          // frontier rows per CTA
constexpr int K4_HH = 8;            // half-plane rows per obstacle slot
constexpr int K4_MAX_OBS = 64;
constexpr int K4_MAX_POINTS = 256;
constexpr int K4_MAX_PRIMS = 32;

__global__ void __launch_bounds__(K4_THREADS)
k4_kernel(const float* __restrict__ pose,           // (B, F, 3)
          const float* __restrict__ cs,             // (B, F, 2) cos, sin of the heading
          const float* __restrict__ hp,             // (B, O, 8, 3)
          const uint8_t* __restrict__ ov,           // (B, O)
          const float* __restrict__ cc,             // (P*C, 2)
          const uint8_t* __restrict__ cc_mask,      // (P*C)
          uint8_t* __restrict__ out,                // (B, F, P)
          int F, int O, int P, int C) {
  __shared__ float s_hp[K4_MAX_OBS * K4_HH * 3];
  __shared__ int s_live[K4_MAX_OBS];
  __shared__ int s_nlive;
  __shared__ float s_cc[K4_MAX_POINTS * 2];
  __shared__ uint8_t s_cm[K4_MAX_POINTS];
  __shared__ int s_hit[K4_ROWS * K4_MAX_PRIMS];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * K4_ROWS;
  const int tid = threadIdx.x;
  const int PC = P * C;
  const int nrows = min(K4_ROWS, F - f0);

  const float* hp_b = hp + (size_t)b * O * K4_HH * 3;
  for (int i = tid; i < O * K4_HH * 3; i += blockDim.x) s_hp[i] = hp_b[i];
  for (int i = tid; i < PC; i += blockDim.x) {
    s_cc[2 * i] = cc[2 * i];
    s_cc[2 * i + 1] = cc[2 * i + 1];
    s_cm[i] = cc_mask[i];
  }
  for (int i = tid; i < K4_ROWS * P; i += blockDim.x) s_hit[i] = 0;
  if (tid == 0) {
    int n = 0;
    for (int o = 0; o < O; ++o)
      if (ov[(size_t)b * O + o]) s_live[n++] = o;
    s_nlive = n;
  }
  __syncthreads();

  for (int item = tid; item < nrows * PC; item += blockDim.x) {
    const int fl = item / PC;
    const int pc = item - fl * PC;
    if (!s_cm[pc]) continue;
    const size_t fi = (size_t)b * F + f0 + fl;
    const float ex = pose[3 * fi], ey = pose[3 * fi + 1];
    const float c = cs[2 * fi], s = cs[2 * fi + 1];
    const float px = s_cc[2 * pc], py = s_cc[2 * pc + 1];
    const float wx = (ex + c * px) - s * py;
    const float wy = (ey + s * px) + c * py;
    bool hit = false;
    for (int k = 0; k < s_nlive && !hit; ++k) {
      const float* h = s_hp + s_live[k] * K4_HH * 3;
      bool inside = true;
      for (int r = 0; r < K4_HH; ++r) {
        const float v = (h[3 * r] * wx + h[3 * r + 1] * wy) + h[3 * r + 2];
        if (!(v <= 0.0f)) {
          inside = false;
          break;
        }
      }
      hit = inside;
    }
    if (hit) s_hit[fl * P + pc / C] = 1;   // every writer stores the same 1
  }
  __syncthreads();

  uint8_t* out_b = out + ((size_t)b * F + f0) * P;
  for (int i = tid; i < nrows * P; i += blockDim.x) out_b[i] = s_hit[i] != 0;
}

}  // namespace

extern "C" int k4_frontier_collision(const float* pose, const float* cs, const float* hp,
                                     const uint8_t* ov, const float* cc, const uint8_t* cc_mask,
                                     uint8_t* out, int B, int F, int O, int P, int C,
                                     cudaStream_t stream) {
  if (B <= 0 || F <= 0 || P <= 0 || C <= 0 || O < 0 || O > K4_MAX_OBS ||
      P > K4_MAX_PRIMS || P * C > K4_MAX_POINTS || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + K4_ROWS - 1) / K4_ROWS, B);
  k4_kernel<<<grid, K4_THREADS, 0, stream>>>(pose, cs, hp, ov, cc, cc_mask, out, F, O, P, C);
  return (int)cudaGetLastError();
}
