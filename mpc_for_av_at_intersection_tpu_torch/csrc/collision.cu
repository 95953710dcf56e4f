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
// Design: one CTA of 8 warps per (scenario, block of K4_ROWS = 64 frontier
// rows); a launch covers the whole batch (one launch per beam iteration).
// The scenario's live rows come packed once per search by
// ops/collision.py::pack_collision: the live obstacles in slot order, each
// as 8 float4 rows (a, b, c, 0), and their count. The CTA copies them to
// shared memory once. A warp takes one frontier pose at a time, and each
// lane K = ceil(P*C / 32) consecutive collision points of it (points of one
// primitive lie side by side, so a lane's points leave an obstacle at the
// same row as a rule). A lane reads each row once, as one 16-byte load that
// every lane of the warp at that row shares (a broadcast), and tests it
// against all of its points still inside that obstacle. Row 0 of every
// obstacle is tested on a short path; rows 1-7 only while some point of
// the lane is still inside. A point leaves an obstacle at its first
// violated row and stops at its first obstacle hit (its coordinates become
// NaN, which violate every row), as the plain version's count
// (rows_tested) charges. The warp ORs its lanes' primitive bits
// (__reduce_or_sync) and writes the pose's P flags once. The TPU kernel kept the (rows, points) violation tensor in VMEM
// and grouped points into primitives with an MXU product; neither is
// needed here.
//
// What bounds it on an H100 (chip_smoke.py --k1k4-times): issue. At the
// beam's width (B=1024, F=256, 90 points, ~1.0e9 row tests a launch) the
// FP work alone is ~0.13 ms. A warp's visit to an obstacle costs ~20
// instructions for its 90 points (the broadcast load, 12 FP operations, 3
// compares, the branch) and each row past row 0 ~18; ~1,150 a pose keep
// the SM at nearly full issue while its CTAs run. The one-point-a-thread
// version spent ~12 instructions and three 4-byte shared loads on a row
// of 32 points. Fewer would take a compare without the add of c (exact
// for finite rows, not for inf - inf) or skipping rows that rows_tested
// counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K4_THREADS = 256;
constexpr int K4_WARPS = K4_THREADS / 32;
constexpr int K4_ROWS = 64;         // frontier rows per CTA
constexpr int K4_HH = 8;            // half-plane rows per obstacle slot
constexpr int K4_MAX_OBS = 64;
constexpr int K4_MAX_POINTS = 256;
constexpr int K4_MAX_PRIMS = 32;

template <int K>
__global__ void __launch_bounds__(K4_THREADS)
k4_kernel(const float* __restrict__ pose,           // (B, F, 3)
          const float* __restrict__ cs,             // (B, F, 2) cos, sin of the heading
          const float4* __restrict__ live,          // (B, O, 8) rows of the live obstacles
          const int* __restrict__ n_live,           // (B,)
          const float* __restrict__ cc,             // (P*C, 2)
          const uint8_t* __restrict__ cc_mask,      // (P*C)
          uint8_t* __restrict__ out,                // (B, F, P)
          int F, int O, int P, int C) {
  __shared__ float4 s_rows[K4_MAX_OBS * K4_HH];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * K4_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PC = P * C;
  const int nl = n_live[b];

  // the whole slot table (rows past the live count are zero), so that no
  // load waits for another
  const float4* live_b = live + (size_t)b * O * K4_HH;
  for (int i = tid; i < O * K4_HH; i += K4_THREADS) s_rows[i] = live_b[i];

  // this lane's points: K consecutive ones from lane * K; a point that is
  // not live keeps NaN coordinates, which violate every row
  float px[K], py[K];
  uint32_t bit[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pc = min(lane * K + q, PC - 1);
    const bool valid = lane * K + q < PC && cc_mask[pc] != 0;
    const float x = cc[2 * pc], y = cc[2 * pc + 1];
    px[q] = valid ? x : __int_as_float(0x7fffffff);
    py[q] = valid ? y : __int_as_float(0x7fffffff);
    bit[q] = valid ? 1u << (pc / C) : 0u;
  }
  __syncthreads();

  const int f_end = min(f0 + K4_ROWS, F);
  for (int f = f0 + warp; f < f_end; f += K4_WARPS) {
    const size_t fi = (size_t)b * F + f;
    const float ex = pose[3 * fi], ey = pose[3 * fi + 1];
    const float c = cs[2 * fi], s = cs[2 * fi + 1];
    float wx[K], wy[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      wx[q] = (ex + c * px[q]) - s * py[q];
      wy[q] = (ey + s * px[q]) + c * py[q];
    }
    uint32_t hits = 0;
#pragma unroll 2
    for (int o = 0; o < nl; ++o) {
      // row 0 for every point; most leave the obstacle here
      const float4* h = s_rows + o * K4_HH;
      bool in[K], any = false;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        in[q] = (h[0].x * wx[q] + h[0].y * wy[q]) + h[0].z <= 0.0f;
        any |= in[q];
      }
      if (!any) continue;
      // rows 1..7 while some point of the lane is still inside
#pragma unroll
      for (int r = 1; r < K4_HH; ++r) {
        const float4 row = h[r];
        bool still = false;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          in[q] = in[q] && (row.x * wx[q] + row.y * wy[q]) + row.z <= 0.0f;
          still |= in[q];
        }
        if (!still) break;
      }
      // a point inside all 8 rows hits: its primitive's flag is set, and
      // NaN coordinates stop it (they violate every later row)
      bool hit = false;
#pragma unroll
      for (int q = 0; q < K; ++q) hit |= in[q];
      if (!hit) continue;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (in[q]) {
          hits |= bit[q];
          wx[q] = wy[q] = __int_as_float(0x7fffffff);
        }
      }
    }
    hits = __reduce_or_sync(0xffffffffu, hits);
    if (lane < P) out[fi * P + lane] = (hits >> lane) & 1u;
  }
}

template <int K>
int launch(const float* pose, const float* cs, const float4* live, const int* n_live,
           const float* cc, const uint8_t* cc_mask, uint8_t* out, int B, int F, int O, int P,
           int C, cudaStream_t stream) {
  const dim3 grid((F + K4_ROWS - 1) / K4_ROWS, B);
  k4_kernel<K><<<grid, K4_THREADS, 0, stream>>>(pose, cs, live, n_live, cc, cc_mask, out, F, O,
                                                P, C);
  return (int)cudaGetLastError();
}

template <int K>
int blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k4_kernel<K>, K4_THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Shapes: pose (B,F,3), cs (B,F,2) float32; live (B,O,8,4) float32, the
// live obstacles' rows (a, b, c, 0) in slot order, n_live (B,) int32 their
// count; cc (P*C,2) float32, cc_mask (P*C) bool; out (B,F,P) bool; all
// contiguous on the device. `K` = ceil(P*C / 32) points a lane. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int k4_frontier_collision(const float* pose, const float* cs, const float* live,
                                     const int* n_live, const float* cc,
                                     const uint8_t* cc_mask, uint8_t* out, int B, int F, int O,
                                     int P, int C, int K, cudaStream_t stream) {
  if (B <= 0 || F <= 0 || P <= 0 || C <= 0 || O < 0 || O > K4_MAX_OBS ||
      P > K4_MAX_PRIMS || P * C > K4_MAX_POINTS || B > 65535 || K != (P * C + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const float4* rows = reinterpret_cast<const float4*>(live);
  switch (K) {
    case 1: return launch<1>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 2: return launch<2>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 3: return launch<3>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 4: return launch<4>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 5: return launch<5>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 6: return launch<6>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    case 7: return launch<7>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
    default: return launch<8>(pose, cs, rows, n_live, cc, cc_mask, out, B, F, O, P, C, stream);
  }
}

// CTAs of the K4 kernel at K points a lane that fit one SM, as the CUDA
// runtime counts them from registers and shared memory; a negative CUDA
// error code on failure.
extern "C" int k4_blocks_per_sm(int K) {
  switch (K) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    case 5: return blocks_per_sm<5>();
    case 6: return blocks_per_sm<6>();
    case 7: return blocks_per_sm<7>();
    case 8: return blocks_per_sm<8>();
    default: return -(int)cudaErrorInvalidValue;
  }
}
