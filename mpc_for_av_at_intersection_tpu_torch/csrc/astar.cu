// K3: serial best-first A* over the quantized (x, y, theta) lattice.
//
// Replaces the TPU kernel mpc_for_av_at_intersection_tpu/ops/astar_pallas.py
// (astar_search_batch -> _kernel). Plain version:
// ops/astar.py::astar_search_reference.
//
// Per scenario: every grid cell holds g, f and the exact continuous pose of
// its best node. Each step pops the open cell of least f (lowest cell index
// among equal f) and closes it (f = inf); a pop inside the goal area ends
// the search. Otherwise the 9 motion primitives are expanded from the exact
// pose: their collision points are tested against every live obstacle's
// half-planes, candidates off the grid are counted (oob), and the survivors
// are committed serially over p = 0..8 wherever g improves by more than
// 1e-6, so a second primitive landing in the same cell is compared against
// the first one's new g. The search stops on a goal pop, an empty open set
// or after max_expansions steps. Outputs: the packed parent*16+prim grid, a
// result row (found, cost, goal cell, expansions, oob) and the number of
// half-plane rows the collision test evaluated (it stops at a point's first
// positive row of an obstacle and at its first obstacle hit).
//
// Design: one CTA (128 threads) per scenario. The grid (up to 466,560 cells
// at 28 bytes per cell, 13 MB per scenario) lives in device memory and L2;
// the TPU kept it in VMEM and found the minimum by scanning the whole f
// grid on every pop, which would read 1.9 MB per step here. Instead thread 0
// keeps a binary min-heap of (f, cell) keys in device memory with lazy
// deletion: an entry is live only while the f stored for its cell equals
// its key bit for bit. A cell's f changes only by a strict g improvement
// (which pushes the new key) or by closing it (inf), so the least live key
// is exactly the grid's argmin with the TPU kernel's lowest-index
// tie-break. The scenario's half-planes and collision points sit in shared
// memory; thread (p, c) tests point c of primitive p, threads 0..8 build the
// candidates and prefetch their cells' g, thread 0 commits.
//
// Floats: this file is compiled with --fmad=false, so every float step
// rounds once as the plain PyTorch version's separate operations do (a
// contracted multiply-add moves a candidate across a cell boundary). The
// remainder follows jnp.mod / torch.remainder: fmodf, then + b when the
// signs differ.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic. A step
// is a chain of dependent device-memory accesses by one thread (the heap
// walk, the commit); the CTAs of a launch run side by side (16 fit on an
// SM, 2112 on the card). The bound the card could reach is the grid
// initialization plus the parent/prim write, about 12 bytes per cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int K3_THREADS = 128;
constexpr int K3_MAX_PRIMS = 16;    // parent/prim packing: pp = cell * 16 + prim
constexpr int K3_PP_SHIFT = 16;
constexpr int K3_MAX_POINTS = K3_THREADS;
constexpr int K3_HH = 8;            // half-plane rows per obstacle slot
constexpr int K3_MAX_OBS = 32;

struct K3Consts {
  float x0, y0, cell, x_hi, y_hi, bin_w, pi, two_pi;
  float h_dist, h_theta, h_steering, h_obstacle, h_center, c_obstacle, c_center;
};

struct K3Ints {
  int nx, ny, ntheta, area_mode, use_edge_obstacle;
  int n_prims, n_cc, n_obs, max_exp, heap_cap;
};

constexpr int K3_NFLOATS = sizeof(K3Consts) / sizeof(float);
constexpr int K3_NINTS = sizeof(K3Ints) / sizeof(int);

struct Row {
  float sx, sy, sth, gx, gy, gth, bx1, by1, bx2, by2, ttol;
};

__device__ __forceinline__ float rem(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ float wrap_pi(const K3Consts& k, float a) {
  return rem(a + k.pi, k.two_pi) - k.pi;
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

__device__ int cell_of(const K3Consts& k, const K3Ints& n, float x, float y, float th) {
  const float ix = clampf(floorf((x - k.x0) / k.cell), (float)(n.nx - 1));
  const float iy = clampf(floorf((y - k.y0) / k.cell), (float)(n.ny - 1));
  const float it = clampf(floorf(rem(th + k.pi, k.two_pi) / k.bin_w), (float)(n.ntheta - 1));
  return (int)ix * (n.ny * n.ntheta) + (int)iy * n.ntheta + (int)it;
}

__device__ float goal_box_dist(const Row& r, float x, float y) {
  const float dx = fmaxf(fmaxf(r.bx1 - x, 0.0f), x - r.bx2);
  const float dy = fmaxf(fmaxf(r.by1 - y, 0.0f), y - r.by2);
  return sqrtf(dx * dx + dy * dy);
}

// 1 / (least distance to a half-plane boundary of a live obstacle); rows
// with a zero norm are padding
__device__ float obstacle_prox(const float* s_hp, const float* s_hpn, int n_rows, float x,
                               float y) {
  float dmin = INFINITY;
  for (int i = 0; i < n_rows; ++i) {
    const float nrm = s_hpn[i];
    if (nrm > 1e-9f) {
      const float* h = s_hp + 3 * i;
      dmin = fminf(dmin, fabsf(h[0] * x + h[1] * y + h[2]) / nrm);
    }
  }
  return 1.0f / fmaxf(dmin, 1e-9f);
}

__device__ float heuristic(const K3Consts& k, const K3Ints& n, const Row& r, const float* s_hp,
                           const float* s_hpn, float x, float y, float th) {
  const float adth = fabsf(th - r.gth);
  float h;
  if (n.area_mode) {
    h = goal_box_dist(r, x, y) + 2.7f * fmaxf(adth - r.ttol, 0.0f);
  } else {
    const float dx = x - r.gx, dy = y - r.gy;
    const float d = sqrtf(dx * dx + dy * dy);
    const float dth = fminf(adth, adth - r.ttol / 2.0f);
    h = k.h_dist * d + k.h_theta * dth;
  }
  if (k.h_steering != 0.0f) h = h + k.h_steering * fabsf(wrap_pi(k, r.gth - th));
  if (k.h_obstacle != 0.0f) h = h + k.h_obstacle * obstacle_prox(s_hp, s_hpn, n.n_obs * K3_HH, x, y);
  if (k.h_center != 0.0f) h = h + k.h_center * sqrtf(x * x + y * y);
  return h;
}

__device__ __forceinline__ bool key_less(float fa, int ca, float fb, int cb) {
  return fa < fb || (fa == fb && ca < cb);
}

__device__ void heap_push(float* hf, int* hc, int& size, float f, int c) {
  int i = size++;
  while (i > 0) {
    const int p = (i - 1) >> 1;
    if (!key_less(f, c, hf[p], hc[p])) break;
    hf[i] = hf[p];
    hc[i] = hc[p];
    i = p;
  }
  hf[i] = f;
  hc[i] = c;
}

__device__ void heap_pop(float* hf, int* hc, int& size) {
  --size;
  if (size == 0) return;
  const float lf = hf[size];
  const int lc = hc[size];
  int i = 0;
  while (true) {
    const int l = 2 * i + 1;
    if (l >= size) break;
    const int r = l + 1;
    const int m = (r < size && key_less(hf[r], hc[r], hf[l], hc[l])) ? r : l;
    if (!key_less(hf[m], hc[m], lf, lc)) break;
    hf[i] = hf[m];
    hc[i] = hc[m];
    i = m;
  }
  hf[i] = lf;
  hc[i] = lc;
}

enum : int { kExpand = 0, kStop = 1 };

__global__ void __launch_bounds__(K3_THREADS)
astar_kernel(const float* __restrict__ hp, const float* __restrict__ hpn,
             const unsigned char* __restrict__ ov, const float* __restrict__ params,
             const float* __restrict__ cc, const unsigned char* __restrict__ cc_mask,
             const float* __restrict__ ends, const float* __restrict__ edge, const int N,
             const K3Consts k, const K3Ints n, float* __restrict__ g_all,
             float* __restrict__ f_all, float* __restrict__ px_all, float* __restrict__ py_all,
             float* __restrict__ pth_all, float* __restrict__ hf_all, int* __restrict__ hc_all,
             int* __restrict__ pp_all, float* __restrict__ cost_out, int* __restrict__ res_out,
             long long* __restrict__ tested_out) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t grid_off = (size_t)b * N;
  float* g = g_all + grid_off;
  float* f = f_all + grid_off;
  float* px = px_all + grid_off;
  float* py = py_all + grid_off;
  float* pth = pth_all + grid_off;
  int* pp = pp_all + grid_off;
  float* hf = hf_all + (size_t)b * n.heap_cap;
  int* hc = hc_all + (size_t)b * n.heap_cap;

  const int P = n.n_prims, C = n.n_cc, NP = P * C, n_rows = n.n_obs * K3_HH;

  __shared__ float s_hp[K3_MAX_OBS * K3_HH * 3];
  __shared__ float s_hpn[K3_MAX_OBS * K3_HH];
  __shared__ int s_ov[K3_MAX_OBS];
  __shared__ float s_ccx[K3_MAX_POINTS], s_ccy[K3_MAX_POINTS];
  __shared__ int s_ccm[K3_MAX_POINTS], s_pt_hit[K3_MAX_POINTS];
  __shared__ float s_ex[K3_MAX_PRIMS], s_ey[K3_MAX_PRIMS], s_et[K3_MAX_PRIMS], s_edge[K3_MAX_PRIMS];
  __shared__ float s_cg[K3_MAX_PRIMS], s_cf[K3_MAX_PRIMS], s_cx[K3_MAX_PRIMS], s_cy[K3_MAX_PRIMS],
      s_ct[K3_MAX_PRIMS], s_oldg[K3_MAX_PRIMS];
  __shared__ int s_ccell[K3_MAX_PRIMS], s_valid[K3_MAX_PRIMS], s_oob[K3_MAX_PRIMS];
  __shared__ float s_pos[4];  // popped x, y, theta, g
  __shared__ int s_cell, s_flag;
  __shared__ unsigned long long s_tested;

  Row r;
  {
    const float* pr = params + (size_t)b * 11;
    r = Row{pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8], pr[9], pr[10]};
  }
  for (int i = tid; i < n_rows * 3; i += K3_THREADS) s_hp[i] = hp[(size_t)b * n_rows * 3 + i];
  for (int i = tid; i < n_rows; i += K3_THREADS) s_hpn[i] = hpn[(size_t)b * n_rows + i];
  for (int i = tid; i < n.n_obs; i += K3_THREADS) s_ov[i] = ov[(size_t)b * n.n_obs + i];
  if (tid < NP) {
    s_ccx[tid] = cc[2 * tid];
    s_ccy[tid] = cc[2 * tid + 1];
    s_ccm[tid] = cc_mask[tid];
  }
  if (tid < P) {
    s_ex[tid] = ends[3 * tid];
    s_ey[tid] = ends[3 * tid + 1];
    s_et[tid] = ends[3 * tid + 2];
    s_edge[tid] = edge[tid];
  }
  for (int i = tid; i < N; i += K3_THREADS) {
    g[i] = INFINITY;
    f[i] = INFINITY;
    pp[i] = -1;
  }
  if (tid == 0) s_tested = 0ull;
  __syncthreads();
  int tested = 0;  // half-plane rows this thread's collision test evaluated

  // thread 0's search state
  int heap_size = 0, n_exp = 0, oob = 0, found = 0, goal_cell = -1;
  float cost = INFINITY;
  if (tid == 0) {
    const int sc = cell_of(k, n, r.sx, r.sy, r.sth);
    const float h0 = heuristic(k, n, r, s_hp, s_hpn, r.sx, r.sy, r.sth);
    g[sc] = 0.0f;
    f[sc] = h0;
    px[sc] = r.sx;
    py[sc] = r.sy;
    pth[sc] = r.sth;
    if (h0 < INFINITY) heap_push(hf, hc, heap_size, h0, sc);
  }

  for (int step = 0; step < n.max_exp; ++step) {
    if (tid == 0) {
      // pop the least live key; stale entries are dropped on the way
      int cell = -1;
      while (heap_size > 0) {
        const float kf = hf[0];
        const int kc = hc[0];
        heap_pop(hf, hc, heap_size);
        if (__float_as_int(f[kc]) == __float_as_int(kf)) {
          cell = kc;
          break;
        }
      }
      s_flag = kStop;
      if (cell >= 0) {
        const float gc = g[cell], cx = px[cell], cy = py[cell], cth = pth[cell];
        f[cell] = INFINITY;  // close
        ++n_exp;
        const bool hit = goal_box_dist(r, cx, cy) <= 1e-5f && fabsf(cth - r.gth) <= r.ttol;
        if (hit) {
          found = 1;
          cost = gc;
          goal_cell = cell;
        } else {
          s_pos[0] = cx;
          s_pos[1] = cy;
          s_pos[2] = cth;
          s_pos[3] = gc;
          s_cell = cell;
          s_flag = kExpand;
        }
      }
    }
    __syncthreads();
    if (s_flag == kStop) break;

    const float cx = s_pos[0], cy = s_pos[1], cth = s_pos[2], gc = s_pos[3];
    const float cs = cosf(cth), sn = sinf(cth);

    // collision: point tid of the primitive set against every live obstacle
    if (tid < NP) {
      int hit = 0;
      if (s_ccm[tid]) {
        const float wx = cx + cs * s_ccx[tid] - sn * s_ccy[tid];
        const float wy = cy + sn * s_ccx[tid] + cs * s_ccy[tid];
        for (int o = 0; o < n.n_obs && !hit; ++o) {
          if (!s_ov[o]) continue;
          bool inside = true;
          for (int j = 0; j < K3_HH; ++j) {
            const float* h = s_hp + 3 * (o * K3_HH + j);
            ++tested;
            if (h[0] * wx + h[1] * wy + h[2] > 0.0f) {
              inside = false;
              break;
            }
          }
          hit = inside;
        }
      }
      s_pt_hit[tid] = hit;
    }
    __syncthreads();

    // candidates, one thread per primitive
    if (tid < P) {
      bool collide = false;
      for (int c = 0; c < C; ++c) collide |= s_pt_hit[tid * C + c] != 0;
      const float x = cx + cs * s_ex[tid] - sn * s_ey[tid];
      const float y = cy + sn * s_ex[tid] + cs * s_ey[tid];
      const float t = wrap_pi(k, s_et[tid] + cth);
      float cg = gc + s_edge[tid];
      if (n.use_edge_obstacle) cg = cg + k.c_obstacle * obstacle_prox(s_hp, s_hpn, n_rows, x, y);
      if (k.c_center != 0.0f) cg = cg + k.c_center * sqrtf(x * x + y * y);
      const bool inb = x >= k.x0 && x < k.x_hi && y >= k.y0 && y < k.y_hi;
      const bool valid = !collide && inb;
      const int ccell = cell_of(k, n, x, y, t);
      s_cx[tid] = x;
      s_cy[tid] = y;
      s_ct[tid] = t;
      s_cg[tid] = cg;
      s_cf[tid] = cg + heuristic(k, n, r, s_hp, s_hpn, x, y, t);
      s_ccell[tid] = ccell;
      s_valid[tid] = valid;
      s_oob[tid] = !collide && !inb;
      s_oldg[tid] = valid ? g[ccell] : INFINITY;
    }
    __syncthreads();

    // serial commit over p; an earlier primitive's commit to the same cell
    // replaces the prefetched g
    if (tid == 0) {
      const int parent = s_cell * K3_PP_SHIFT;
      for (int p = 0; p < P; ++p) {
        oob += s_oob[p];
        if (!s_valid[p]) continue;
        const int kc = s_ccell[p];
        float oldg = s_oldg[p];
        for (int q = 0; q < p; ++q)
          if (s_valid[q] == 2 && s_ccell[q] == kc) oldg = s_cg[q];
        const float vg = s_cg[p];
        if (vg < oldg - 1e-6f) {
          const float vf = s_cf[p];
          g[kc] = vg;
          f[kc] = vf;
          px[kc] = s_cx[p];
          py[kc] = s_cy[p];
          pth[kc] = s_ct[p];
          pp[kc] = parent + p;
          s_valid[p] = 2;  // committed
          if (vf < INFINITY) heap_push(hf, hc, heap_size, vf, kc);
        }
      }
    }
    // thread 0 pops next; the others wait for it at the barrier after the pop
  }

  if (tested) atomicAdd(&s_tested, (unsigned long long)tested);
  __syncthreads();
  if (tid == 0) {
    cost_out[b] = found ? cost : INFINITY;
    int* res = res_out + (size_t)b * 4;
    res[0] = found;
    res[1] = goal_cell;
    res[2] = n_exp;
    res[3] = oob;
    tested_out[b] = (long long)s_tested;
  }
}

}  // namespace

extern "C" {

int k3_num_floats() { return K3_NFLOATS; }
int k3_num_ints() { return K3_NINTS; }

// Shapes: hp (B, O, 8, 3), hpn (B, O*8), ov (B, O) bool, params (B, 11)
// [start x y theta, goal x y theta, goal box x1 y1 x2 y2, theta tol],
// cc (P*C, 2), cc_mask (P*C) bool, ends (P, 3), edge (P,); scratch g, f, px,
// py, pth (B, N) float32 and heap keys (B, heap_cap) float32 + int32; out pp
// (B, N) int32, cost (B,) float32, res (B, 4) int32 [found, goal cell,
// expansions, oob], tested (B,) int64 half-plane rows the collision test
// evaluated (its work on these inputs). `fconsts` / `iconsts` are host
// arrays in K3Consts / K3Ints order. Returns the CUDA error code of the
// launch (0 = launched).
int k3_astar(const float* hp, const float* hpn, const unsigned char* ov, const float* params,
             const float* cc, const unsigned char* cc_mask, const float* ends, const float* edge,
             int B, int N, const float* fconsts, const int* iconsts, float* g, float* f,
             float* px, float* py, float* pth, float* heap_f, int* heap_c, int* pp, float* cost,
             int* res, long long* tested, void* stream) {
  if (B <= 0) return 0;
  K3Consts k;
  K3Ints n;
  memcpy(&k, fconsts, sizeof(K3Consts));
  memcpy(&n, iconsts, sizeof(K3Ints));
  if (n.n_prims > K3_MAX_PRIMS || n.n_prims * n.n_cc > K3_MAX_POINTS || n.n_obs > K3_MAX_OBS ||
      n.heap_cap < 1 + n.n_prims * n.max_exp || N != n.nx * n.ny * n.ntheta)
    return (int)cudaErrorInvalidValue;
  astar_kernel<<<B, K3_THREADS, 0, (cudaStream_t)stream>>>(
      hp, hpn, ov, params, cc, cc_mask, ends, edge, N, k, n, g, f, px, py, pth, heap_f, heap_c,
      pp, cost, res, tested);
  return (int)cudaGetLastError();
}

}  // extern "C"
