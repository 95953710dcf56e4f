// The conflict scan's first hit: agents/collision.py::check_collision_moving_cars
// on the card, one CTA a row.
//
// Replaces no TPU kernel: the JAX package computes the scan in plain jnp
// (mpc_for_av_at_intersection_tpu/agents/collision.py::check_collision_moving_cars).
// It is written by hand because the plain torch scan writes its pairwise
// hit test out in full, (rows, n_obs, S, n_c, n_c, n_frames), through some
// eight elementwise kernels and one min before it can pick a row's first
// hit: 85-94% of the plain torch of a fleet tick on an H100. Plain
// version: agents/collision.py::check_collision_moving_cars_reference.
//
// What it computes, for row b: the least key
//   (((f * n_c + ce) * n_obs + o) * S + s) * n_c + co
// over the frames f < min(max(n_ego, n_pred), n_frames), ego circles ce,
// active obstacles o, shifts s and obstacle circles co whose ego circle
// point (pose min(f, n_ego - 1)) and obstacle circle point (prediction
// frame clamp(f - s + frame_window, 0, n_pred - 1)) lie within
// min_d2 = (2 radius)^2 of each other; that point again; its first index
// on the detailed path (circle-major over (n_c, N_T), t < n_detail, index 0
// where none); and the frames the row walked. Points are placed as
// (x + c*ox) - s*oy and (y + s*ox) + c*oy with the cosines and sines the
// wrapper computed in torch, and tested as (dx*dx + dy*dy) <= min_d2 with
// min_d2 rounded to float32, every step rounded on its own (this file is
// built with --fmad=false): the plain version's separate tensor operations,
// so every output is the plain version's bit for bit.
//
// What bounds it on an H100: its least work is small. A row's inputs are a
// few KB (n_obs x n_pred poses, its ego course and detailed path), read
// once: ~0.07 ms at the benchmark cells' shapes (8,192 rows of 10 obstacle
// slots; 10,000 rows of 4). Its pair tests, ~6 FP operations each, take
// less: 1.7e9 tests at the 8,192 rows with no early exit would be ~0.15 ms
// at 67 TFLOP/s, and the early exit leaves ~2e8. The plain version's time
// (31-62 ms) is its intermediates' round trips through device memory. The
// kernel's own time (0.27-0.43 ms, chip_smoke.py --scan-times) is its
// frame walk: a CTA's frames run one after another, a barrier each.
// The design keeps everything in registers and shared memory and does not
// do the work no answer needs:
// - the key is frame-major, so the CTA walks the frames in order and stops
//   after the first frame that holds a hit: no later key is smaller;
// - inactive obstacles are not tested, not masked: warp 0 packs the active
//   slots' indices, and the threads share out only their (obstacle, shift,
//   obstacle circle) units, each testing its point against the frame's n_c
//   ego circle points;
// - frames past n_iter are never read.
// The CTA places the active obstacles' circle points in shared memory once
// (tile_obs obstacles at a time where they do not all fit; with tile_obs 0
// each point is placed from device memory where a test needs it), and the
// ego circle points a chunk of ego_points (frame, circle) pairs at a time.
// Consecutive threads take consecutive shifts, so a warp reads consecutive
// points. A frame ends in one __syncthreads_or; only a frame with a hit
// pays for the CTA's min. Several tiles walk the frames each, up to the
// frame of the best key found so far.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SCAN_MAX_THREADS = 1024;
constexpr int SCAN_SMEM_LIMIT = 232448;   // an H100 CTA's shared memory
constexpr int SCAN_CTL_INTS = 40;         // 32 warp minima, the min, the tile's count and cursor

struct Point {
  float x, y;
};

// the circle centre (ox, oy) of a pose (x, y) with heading cosine c and sine s
__device__ __forceinline__ Point place(float x, float y, float c, float s, float ox, float oy) {
  return {__fsub_rn(__fadd_rn(x, __fmul_rn(c, ox)), __fmul_rn(s, oy)),
          __fadd_rn(__fadd_rn(y, __fmul_rn(s, ox)), __fmul_rn(c, oy))};
}

__device__ __forceinline__ bool within(Point a, Point b, float min_d2) {
  const float dx = __fsub_rn(a.x, b.x), dy = __fsub_rn(a.y, b.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= min_d2;
}

// the least v over the CTA; every thread gets it. ctl[0..32] is scratch.
__device__ int block_min(int v, int* ctl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) ctl[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? ctl[lane] : INT_MAX;
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) ctl[32] = w;
  }
  __syncthreads();
  return ctl[32];
}

struct ScanArgs {
  const float* ego;       // (B, N_F, 3)
  const float* ego_cos;   // (B, N_F)
  const float* ego_sin;
  const int* n_ego;       // (B,)
  const float* det;       // (B, N_T, 3)
  const float* det_cos;   // (B, N_T)
  const float* det_sin;
  const int* n_det;       // (B,)
  const float* obs;       // (B, n_obs, n_pred, 3)
  const float* obs_cos;   // (B, n_obs, n_pred)
  const float* obs_sin;
  const uint8_t* active;  // (B, n_obs)
  const float* centers;   // (n_c, 2)
  float min_d2;
  int N_F, N_T, n_obs, n_pred, n_c, frame_window, n_frames, tile_obs, ego_points;
  uint8_t* found;         // (B,)
  float* xy;              // (B, 2)
  int* frame_idx;         // (B,)
  int* frames;            // (B,)
};

__device__ __forceinline__ Point obs_point(const ScanArgs& a, int b, int o, int co, int j) {
  const size_t g = ((size_t)b * a.n_obs + o) * a.n_pred + j;
  return place(a.obs[3 * g], a.obs[3 * g + 1], a.obs_cos[g], a.obs_sin[g], a.centers[2 * co],
               a.centers[2 * co + 1]);
}

__global__ void scan_kernel(const ScanArgs a) {
  extern __shared__ float smem[];
  const int tile_pts = a.tile_obs * a.n_c * a.n_pred;
  float* px = smem;                                  // [tile_pts]
  float* py = px + tile_pts;                         // [tile_pts]
  float* ex = py + tile_pts;                         // [ego_points]
  float* ey = ex + a.ego_points;                     // [ego_points]
  int* act = reinterpret_cast<int*>(ey + a.ego_points);   // [max(tile_obs, 1)]
  int* ctl = act + max(a.tile_obs, 1);               // [SCAN_CTL_INTS]

  const int b = blockIdx.x;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_c = a.n_c, n_obs = a.n_obs, n_pred = a.n_pred, fw = a.frame_window;
  const int S = 2 * fw + 1;
  const int ne = a.n_ego[b];
  const int n_walk = min(max(ne, n_pred), a.n_frames);
  const int ego_last = min(max(ne - 1, 0), a.N_F - 1);
  const int key_per_q = n_obs * S * n_c;             // keys of one (frame, ego circle)
  const int cap = max(a.tile_obs, 1);

  // this thread's first unit (s fastest, then co, then the tile's obstacle)
  // and the step to its next one, T units on
  const int s0 = tid % S, co0 = (tid / S) % n_c, oa0 = tid / (S * n_c);
  const int ds = T % S, dco = (T / S) % n_c, doa = T / (S * n_c);

  int best = INT_MAX, q_lim = n_walk * n_c, cursor = 0, n_active = 0;
  for (;;) {
    // the tile: the next `cap` active slots from `cursor`, in slot order
    if (warp == 0) {
      int got = 0, cur = cursor;
      while (cur < n_obs && got < cap) {
        const int o = cur + lane;
        const bool on = o < n_obs && a.active[(size_t)b * n_obs + o] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, on);
        const int rank = __popc(m & ((1u << lane) - 1u));
        const int take = min(__popc(m), cap - got);
        if (on && rank < take) act[got + rank] = o;
        if (__popc(m) > take) {   // the tile is full inside these 32 slots
          const unsigned last = __ballot_sync(0xffffffffu, on && rank == take - 1);
          cur += __ffs(last);
        } else {
          cur += 32;
        }
        got += take;
      }
      if (lane == 0) {
        ctl[33] = got;
        ctl[34] = cur;
      }
    }
    __syncthreads();
    const int a_t = ctl[33];
    cursor = ctl[34];
    if (a_t == 0) break;
    n_active += a_t;
    for (int i = tid; i < a_t * n_c * n_pred && a.tile_obs > 0; i += T) {
      const int j = i % n_pred, t = i / n_pred;
      const Point p = obs_point(a, b, act[t / n_c], t % n_c, j);
      px[i] = p.x;
      py[i] = p.y;
    }

    // walk the (frame, ego circle) pairs q in order, a chunk of ego points at
    // a time, a frame a step; stop after the first step with a hit
    int tile_best = INT_MAX;
    for (int q0 = 0; q0 < q_lim && tile_best == INT_MAX; q0 += a.ego_points) {
      const int qn = min(a.ego_points, q_lim - q0);
      __syncthreads();   // the tile's points are placed, the last chunk's read
      for (int i = tid; i < qn; i += T) {
        const int q = q0 + i, f = q / n_c, ce = q - f * n_c;
        const size_t g = (size_t)b * a.N_F + min(f, ego_last);
        const Point p = place(a.ego[3 * g], a.ego[3 * g + 1], a.ego_cos[g], a.ego_sin[g],
                              a.centers[2 * ce], a.centers[2 * ce + 1]);
        ex[i] = p.x;
        ey[i] = p.y;
      }
      __syncthreads();
      for (int qa = q0; qa < q0 + qn;) {
        const int f = qa / n_c;
        const int qb = min((f + 1) * n_c, q0 + qn);
        int mine = INT_MAX;
        int s = s0, co = co0, oa = oa0;
        while (oa < a_t) {
          const int o = act[oa];
          const int j = min(max(f - s + fw, 0), n_pred - 1);
          Point op;
          if (a.tile_obs > 0) {
            const int i = (oa * n_c + co) * n_pred + j;
            op = {px[i], py[i]};
          } else {
            op = obs_point(a, b, o, co, j);
          }
          for (int q = qa; q < qb; ++q) {   // ego circles in order: the first hit is the least
            if (within({ex[q - q0], ey[q - q0]}, op, a.min_d2)) {
              mine = min(mine, ((q * n_obs + o) * S + s) * n_c + co);
              break;
            }
          }
          s += ds;
          const int c1 = s >= S;
          s -= c1 ? S : 0;
          co += dco + c1;
          const int c2 = co >= n_c;
          co -= c2 ? n_c : 0;
          oa += doa + c2;
        }
        if (__syncthreads_or(mine != INT_MAX)) {
          tile_best = block_min(mine, ctl);
          break;
        }
        qa = qb;
      }
    }
    if (tile_best < best) {
      best = tile_best;
      q_lim = best / key_per_q + 1;   // later tiles walk no frame past it
    }
    __syncthreads();   // every thread is done with this tile's slots and points
  }

  // decode the first hit (key 0 where none) and place that obstacle point
  const bool hit = best != INT_MAX;
  const int key = hit ? best : 0;
  const int co = key % n_c, s = (key / n_c) % S, o = (key / (n_c * S)) % n_obs;
  const int f = key / (key_per_q * n_c);
  const Point op = obs_point(a, b, o, co, min(max(f - (s - fw), 0), n_pred - 1));

  // its first index on the detailed path, circle-major over t < n_detail
  const int nd = min(max(a.n_det[b], 0), a.N_T);
  int first = INT_MAX;
  for (int i0 = 0; i0 < n_c * nd; i0 += T) {
    const int i = i0 + tid;
    bool near = false;
    if (i < n_c * nd) {
      const int ce = i / nd, t = i - ce * nd;
      const size_t g = (size_t)b * a.N_T + t;
      near = within(place(a.det[3 * g], a.det[3 * g + 1], a.det_cos[g], a.det_sin[g],
                          a.centers[2 * ce], a.centers[2 * ce + 1]), op, a.min_d2);
    }
    if (__syncthreads_or(near)) {
      first = block_min(near ? i : INT_MAX, ctl);
      break;
    }
  }
  if (tid == 0) {
    const int t = first == INT_MAX ? 0 : first % nd;
    const size_t g = (size_t)b * a.N_T + t;
    a.found[b] = hit;
    a.frame_idx[b] = t;
    a.xy[2 * b] = a.det[3 * g];
    a.xy[2 * b + 1] = a.det[3 * g + 1];
    a.frames[b] = n_active == 0 ? 0 : hit ? f + 1 : n_walk;
  }
}

// shared memory of one CTA, in bytes (-1: more than an H100 CTA has), as
// ops/scan.py::smem_bytes counts it
int smem_bytes(int n_c, int n_pred, int tile_obs, int ego_points) {
  const long long bytes = 8LL * tile_obs * n_c * n_pred + 8LL * ego_points +
                          4LL * (tile_obs > 0 ? tile_obs : 1) + 4LL * SCAN_CTL_INTS;
  return bytes > SCAN_SMEM_LIMIT ? -1 : (int)bytes;
}

}  // namespace

// Shapes: ego (B,N_F,3), ego_cos/ego_sin (B,N_F), det (B,N_T,3),
// det_cos/det_sin (B,N_T), obs (B,n_obs,n_pred,3), obs_cos/obs_sin
// (B,n_obs,n_pred), centers (n_c,2), xy (B,2) float32; n_ego, n_det,
// frame_idx, frames (B,) int32; active (B,n_obs), found (B,) bool; all
// contiguous on the device. min_d2 is (2 radius)^2 rounded to float32.
// Launch shape: `threads` a CTA (a multiple of 32), `tile_obs` active
// obstacles' points in shared memory at a time (0: none, placed from device
// memory), `ego_points` (frame, circle) ego points a chunk. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int scan_first_hit(const float* ego, const float* ego_cos, const float* ego_sin,
                              const int* n_ego, const float* det, const float* det_cos,
                              const float* det_sin, const int* n_det, const float* obs,
                              const float* obs_cos, const float* obs_sin, const uint8_t* active,
                              const float* centers, float min_d2, int B, int N_F, int N_T,
                              int n_obs, int n_pred, int n_c, int frame_window, int n_frames,
                              int threads, int tile_obs, int ego_points, uint8_t* found,
                              float* xy, int* frame_idx, int* frames, cudaStream_t stream) {
  const long long S = 2LL * frame_window + 1;
  if (B <= 0 || N_F <= 0 || N_T <= 0 || n_obs <= 0 || n_pred <= 0 || n_c <= 0 ||
      frame_window < 0 || n_frames <= 0 || threads < 32 || threads > SCAN_MAX_THREADS ||
      threads % 32 != 0 || tile_obs < 0 || tile_obs > n_obs || ego_points <= 0 ||
      (long long)n_frames * n_c * n_obs * S * n_c >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n_c, n_pred, tile_obs, ego_points);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const ScanArgs args{ego, ego_cos, ego_sin, n_ego, det, det_cos, det_sin, n_det,
                      obs, obs_cos, obs_sin, active, centers, min_d2,
                      N_F, N_T, n_obs, n_pred, n_c, frame_window, n_frames, tile_obs, ego_points,
                      found, xy, frame_idx, frames};
  scan_kernel<<<B, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}
