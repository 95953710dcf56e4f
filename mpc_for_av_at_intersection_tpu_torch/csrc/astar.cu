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
// Design: one CTA (128 threads) per scenario. The grid (g, f, pose and
// parent/prim of every cell, 24 bytes a cell, 11 MB per scenario at
// 458,000 cells) lives in device memory and L2. The TPU kept it in VMEM and
// found each step's cell by an argmin over the whole f grid; here the open
// set is a two-level min tree over that grid. f is cut into blocks of BLK
// cells (a power of two the wrapper picks, so that ceil(N / BLK) <= 2048),
// and level 1, in shared memory, holds each block's least (f, cell) as one
// 64-bit key: f's bits made order-preserving above the cell index. Level 1
// is exact after every step, so the least key is the grid's argmin with the
// TPU kernel's lowest-index tie-break, and no entry is ever stale:
// - pop: a CTA reduction over level 1; it reads no device memory;
// - close: the popped cell's g and pose and its block's f (BLK / 128
//   coalesced floats a thread) are read in one round trip; the block's new
//   least key, the popped cell read as +inf, replaces its entry;
// - commit: a candidate that lowers its cell's f folds into its block's key
//   with a compare; one that raises the f of its block's least cell marks
//   the block, and the marked blocks are rescanned before the next pop.
// The live obstacles' half-planes (packed in slot order, one 16-byte row
// each) and the collision points sit in shared memory. Thread (p, c) <
// P*C tests point c of primitive p while the last P threads build the
// candidates and fetch their cells' g; lanes p < P of warp 0 then commit
// them together, keeping the serial order's result (a later candidate in
// the same cell is held to the earlier one's new g; the last commit to a
// cell writes it).
//
// Floats: this file is compiled with --fmad=false, so every float step
// rounds once as the plain PyTorch version's separate operations do (a
// contracted multiply-add moves a candidate across a cell boundary). The
// remainder follows jnp.mod / torch.remainder: fmodf, then + b when the
// signs differ.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic. The
// CTAs of a launch run side by side (at least 8 fit on an SM, so 1024
// scenarios are resident at once), and the launch lasts as long as its
// longest search, which runs nearly alone at the end. Its step is a
// serial chain: one device round trip for the popped cell and its block,
// one for the candidates' g (beside the collision test), three barriers.
// By k3_step_split.py on an H100 (1024 sampled geometries, the longest of
// 20,000 steps), about half of a step waits for the collision test's
// slowest point, a fifth is the commit, a seventh the round trip of the
// close and a ninth the pop; the heap walk the min tree replaced was a
// quarter of the old step, the commit of one thread another. The bound
// the card could reach is the grid initialization plus the parent/prim
// write, about 12 bytes per cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int K3_THREADS = 128;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_MIN_CTAS = 8;      // CTAs an SM must hold: 1024 scenarios resident on 132 SMs
constexpr int K3_L1_MAX = 2048;     // level-1 entries, 16 KB of keys
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
  int n_prims, n_cc, n_obs, max_exp, blk;
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
// with a zero norm are padding. The minimum does not depend on the rows'
// order, nor on dead obstacles, whose rows carry a zero norm.
__device__ float obstacle_prox(const float4* s_hp, const float* s_hpn, int n_rows, float x,
                               float y) {
  float dmin = INFINITY;
  for (int i = 0; i < n_rows; ++i) {
    const float nrm = s_hpn[i];
    if (nrm > 1e-9f) {
      const float4 h = s_hp[i];
      dmin = fminf(dmin, fabsf(h.x * x + h.y * y + h.z) / nrm);
    }
  }
  return 1.0f / fmaxf(dmin, 1e-9f);
}

__device__ float heuristic(const K3Consts& k, const K3Ints& n, const Row& r, const float4* s_hp,
                           const float* s_hpn, int n_rows, float x, float y, float th) {
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
  if (k.h_obstacle != 0.0f) h = h + k.h_obstacle * obstacle_prox(s_hp, s_hpn, n_rows, x, y);
  if (k.h_center != 0.0f) h = h + k.h_center * sqrtf(x * x + y * y);
  return h;
}

// (f, cell) as one key whose unsigned order is the lexicographic order of
// (f, cell): f's bits made order-preserving (-0.0 keyed as +0.0) above the
// cell index. Keys at or above KEY_INF are cells of f = +inf.
typedef unsigned long long Key;
constexpr Key KEY_INF = 0xFF800000ull << 32;

__device__ __forceinline__ Key key_of(float f, int cell) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (unsigned)cell;
}

__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }

__device__ __forceinline__ Key warp_min(Key k) {
  for (int o = 16; o > 0; o >>= 1) k = kmin(k, __shfl_xor_sync(0xffffffffu, k, o));
  return k;
}

// this thread's least key over block blk of the f grid, cell `skip` read as
// +inf; every block holds at least one cell, so the CTA's least is a key
__device__ __forceinline__ Key scan_block(const float* f, int blk, int shift, int N, int skip,
                                          int tid) {
  Key m = ~0ull;
  const int lo = blk << shift, hi = min(lo + (1 << shift), N);
#pragma unroll 4
  for (int i = lo + tid; i < hi; i += K3_THREADS)
    m = kmin(m, key_of(i == skip ? INFINITY : f[i], i));
  return m;
}

__global__ void __launch_bounds__(K3_THREADS, K3_MIN_CTAS)
astar_kernel(const float* __restrict__ hp, const float* __restrict__ hpn,
             const unsigned char* __restrict__ ov, const float* __restrict__ params,
             const float* __restrict__ cc, const unsigned char* __restrict__ cc_mask,
             const float* __restrict__ ends, const float* __restrict__ edge, const int N,
             const K3Consts k, const K3Ints n, float* __restrict__ g_all,
             float* __restrict__ f_all, float* __restrict__ px_all, float* __restrict__ py_all,
             float* __restrict__ pth_all, int* __restrict__ pp_all, float* __restrict__ cost_out,
             int* __restrict__ res_out, long long* __restrict__ tested_out) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t grid_off = (size_t)b * N;
  float* g = g_all + grid_off;
  float* f = f_all + grid_off;
  float* px = px_all + grid_off;
  float* py = py_all + grid_off;
  float* pth = pth_all + grid_off;
  int* pp = pp_all + grid_off;

  const int P = n.n_prims, C = n.n_cc, NP = P * C;
  const int shift = __ffs(n.blk) - 1, NB = (N + n.blk - 1) >> shift;
  const int cand = tid - (K3_THREADS - P);  // the primitive whose candidate this thread builds

  extern __shared__ Key s_l1[];  // level 1: the least key of each block of f
  // the live obstacles' rows, in slot order: (a, b, c, 0) of a x + b y + c
  __shared__ float4 s_hp[K3_MAX_OBS * K3_HH];
  __shared__ float s_hpn[K3_MAX_OBS * K3_HH];
  __shared__ int s_live[K3_MAX_OBS], s_n_live;  // the live obstacle slots
  __shared__ float s_ccx[K3_MAX_POINTS], s_ccy[K3_MAX_POINTS];
  __shared__ int s_ccm[K3_MAX_POINTS];
  __shared__ float s_ex[K3_MAX_PRIMS], s_ey[K3_MAX_PRIMS], s_et[K3_MAX_PRIMS], s_edge[K3_MAX_PRIMS];
  __shared__ float s_cg[K3_MAX_PRIMS], s_cf[K3_MAX_PRIMS], s_cx[K3_MAX_PRIMS], s_cy[K3_MAX_PRIMS],
      s_ct[K3_MAX_PRIMS], s_oldg[K3_MAX_PRIMS];
  __shared__ int s_ccell[K3_MAX_PRIMS], s_inb[K3_MAX_PRIMS], s_coll[K3_MAX_PRIMS];
  __shared__ Key s_pop[K3_WARPS], s_close[K3_WARPS], s_rescan[K3_MAX_PRIMS][K3_WARPS];
  __shared__ int s_marked[K3_MAX_PRIMS], s_n_marked;
  __shared__ unsigned long long s_tested;

  Row r;
  {
    const float* pr = params + (size_t)b * 11;
    r = Row{pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8], pr[9], pr[10]};
  }
  if (tid == 0) {
    int live = 0;
    for (int o = 0; o < n.n_obs; ++o)
      if (ov[(size_t)b * n.n_obs + o]) s_live[live++] = o;
    s_n_live = live;
  }
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
    s_coll[tid] = 0;
  }
  for (int i = tid; i < N; i += K3_THREADS) {
    g[i] = INFINITY;
    f[i] = INFINITY;
    pp[i] = -1;
  }
  for (int i = tid; i < NB; i += K3_THREADS) s_l1[i] = key_of(INFINITY, i << shift);
  if (tid == 0) s_tested = 0ull;
  __syncthreads();
  const int n_live = s_n_live, n_rows = n_live * K3_HH;
  for (int i = tid; i < n_rows; i += K3_THREADS) {
    const size_t row = (size_t)b * n.n_obs * K3_HH + s_live[i / K3_HH] * K3_HH + i % K3_HH;
    s_hp[i] = make_float4(hp[3 * row], hp[3 * row + 1], hp[3 * row + 2], 0.0f);
    s_hpn[i] = hpn[row];
  }
  __syncthreads();
  int tested = 0;  // half-plane rows this thread's collision test evaluated

  // thread 0's search state
  int n_exp = 0, oob = 0, found = 0, goal_cell = -1;
  float cost = INFINITY;
  if (tid == 0) {
    const int sc = cell_of(k, n, r.sx, r.sy, r.sth);
    const float h0 = heuristic(k, n, r, s_hp, s_hpn, n_rows, r.sx, r.sy, r.sth);
    g[sc] = 0.0f;
    f[sc] = h0;
    px[sc] = r.sx;
    py[sc] = r.sy;
    pth[sc] = r.sth;
    s_l1[sc >> shift] = kmin(s_l1[sc >> shift], key_of(h0, sc));
  }
  __syncthreads();

  for (int step = 0; step < n.max_exp; ++step) {
    // pop: the least level-1 key, reduced in shared memory by the whole CTA
    Key top = ~0ull;
#pragma unroll 4
    for (int i = tid; i < NB; i += K3_THREADS) top = kmin(top, s_l1[i]);
    top = warp_min(top);
    if (lane == 0) s_pop[warp] = top;
    __syncthreads();
    top = s_pop[0];
    for (int w = 1; w < K3_WARPS; ++w) top = kmin(top, s_pop[w]);
    if (top >= KEY_INF) break;  // no open cell of finite f
    const int cell = (int)(unsigned)top, blk = cell >> shift;

    // close: the popped cell's g and pose and its block's f, one round trip
    const float gc = g[cell], cx = px[cell], cy = py[cell], cth = pth[cell];
    const Key closed = scan_block(f, blk, shift, N, cell, tid);
    if (tid == 0) {
      f[cell] = INFINITY;
      ++n_exp;
    }
    if (goal_box_dist(r, cx, cy) <= 1e-5f && fabsf(cth - r.gth) <= r.ttol) {
      if (tid == 0) {
        found = 1;
        cost = gc;
        goal_cell = cell;
      }
      break;
    }
    const float cs = cosf(cth), sn = sinf(cth);

    // candidates, on the last P threads, beside the collision test
    if (cand >= 0) {
      const float x = cx + cs * s_ex[cand] - sn * s_ey[cand];
      const float y = cy + sn * s_ex[cand] + cs * s_ey[cand];
      const float t = wrap_pi(k, s_et[cand] + cth);
      float cg = gc + s_edge[cand];
      if (n.use_edge_obstacle) cg = cg + k.c_obstacle * obstacle_prox(s_hp, s_hpn, n_rows, x, y);
      if (k.c_center != 0.0f) cg = cg + k.c_center * sqrtf(x * x + y * y);
      const int ccell = cell_of(k, n, x, y, t);
      s_cx[cand] = x;
      s_cy[cand] = y;
      s_ct[cand] = t;
      s_cg[cand] = cg;
      s_cf[cand] = cg + heuristic(k, n, r, s_hp, s_hpn, n_rows, x, y, t);
      s_ccell[cand] = ccell;
      s_inb[cand] = x >= k.x0 && x < k.x_hi && y >= k.y0 && y < k.y_hi;
      s_oldg[cand] = g[ccell];
    }

    // collision: point tid of the primitive set against every live obstacle
    if (tid < NP && s_ccm[tid]) {
      const float wx = cx + cs * s_ccx[tid] - sn * s_ccy[tid];
      const float wy = cy + sn * s_ccx[tid] + cs * s_ccy[tid];
      // an obstacle's rows up to its first positive one; the point stops at
      // its first obstacle that has none
      int hit = 0;
      for (int l = 0; l < n_live && !hit; ++l) {
        const float4* h = s_hp + l * K3_HH;
        int j = 0;
#pragma unroll
        for (; j < K3_HH; ++j)
          if (h[j].x * wx + h[j].y * wy + h[j].z > 0.0f) break;
        tested += j < K3_HH ? j + 1 : K3_HH;
        hit = j == K3_HH;
      }
      if (hit) s_coll[tid / C] = 1;
    }
    const Key closed_w = warp_min(closed);
    if (lane == 0) s_close[warp] = closed_w;
    __syncthreads();

    // commit, on lanes p < P of warp 0, with the serial semantics over p: a
    // candidate commits where its g beats its cell's by more than 1e-6, its
    // cell's g being the one before this step or that of the last earlier
    // candidate committed to the same cell; the last commit to a cell writes it
    if (warp == 0) {
      Key least = s_close[0];
      for (int w = 1; w < K3_WARPS; ++w) least = kmin(least, s_close[w]);
      if (lane == 0) s_l1[blk] = least;
      __syncwarp();
      const unsigned all = 0xffffffffu;
      const bool act = lane < P;
      const bool collide = act && s_coll[lane] != 0;
      const bool inb = act && s_inb[lane] != 0;
      const bool valid = act && !collide && inb;
      const unsigned off_grid = __ballot_sync(all, act && !collide && !inb);
      const int kc = act ? s_ccell[lane] : -1 - lane;  // inactive lanes share no cell
      const float vg = act ? s_cg[lane] : INFINITY;
      float gcell = act ? s_oldg[lane] : INFINITY;
      bool mine = false;  // this lane's candidate commits
      for (int q = 0; q < P; ++q) {
        const int kq = __shfl_sync(all, kc, q);
        const float vq = __shfl_sync(all, vg, q);
        const int ok = __shfl_sync(all, (int)valid, q);
        if (q <= lane && ok && kq == kc && vq < gcell - 1e-6f) {
          gcell = vq;
          mine = q == lane;
        }
      }
      if (act) s_coll[lane] = 0;
      if (lane == 0) oob += __popc(off_grid);
      const unsigned later = __ballot_sync(all, mine) & __match_any_sync(all, kc) &
                             ~((2u << lane) - 1u);
      int mark = -1;  // the block whose least cell this commit raised
      if (mine && later == 0u) {
        const float vf = s_cf[lane];
        g[kc] = vg;
        f[kc] = vf;
        px[kc] = s_cx[lane];
        py[kc] = s_cy[lane];
        pth[kc] = s_ct[lane];
        pp[kc] = cell * K3_PP_SHIFT + lane;
        const int kb = kc >> shift;
        const Key key = key_of(vf, kc), cur = s_l1[kb];
        if (key < cur)
          atomicMin(&s_l1[kb], key);
        else if ((int)(unsigned)cur == kc && key != cur)
          mark = kb;
      }
      // list each marked block once, by the lowest lane that marked it
      const unsigned marking = __ballot_sync(all, mark >= 0);
      const unsigned twins = __match_any_sync(all, mark) & marking;
      const bool first = mark >= 0 && (twins & ((1u << lane) - 1u)) == 0u;
      const unsigned firsts = __ballot_sync(all, first);
      if (first) s_marked[__popc(firsts & ((1u << lane) - 1u))] = mark;
      if (lane == 0) s_n_marked = __popc(firsts);
    }
    __syncthreads();

    // rescan the marked blocks; each entry is written by the thread whose
    // share of the next pop reads it
    const int n_marked = s_n_marked;
    if (n_marked) {
      for (int j = 0; j < n_marked; ++j) {
        const Key m = warp_min(scan_block(f, s_marked[j], shift, N, -1, tid));
        if (lane == 0) s_rescan[j][warp] = m;
      }
      __syncthreads();
      for (int j = 0; j < n_marked; ++j) {
        if (s_marked[j] % K3_THREADS != tid) continue;
        Key m = s_rescan[j][0];
        for (int w = 1; w < K3_WARPS; ++w) m = kmin(m, s_rescan[j][w]);
        s_l1[s_marked[j]] = m;
      }
    }
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
// py, pth (B, N) float32; out pp (B, N) int32, cost (B,) float32, res (B, 4)
// int32 [found, goal cell, expansions, oob], tested (B,) int64 half-plane
// rows the collision test evaluated (its work on these inputs). `fconsts` /
// `iconsts` are host arrays in K3Consts / K3Ints order; K3Ints.blk, the
// cells of a level-1 block, is a power of two with ceil(N / blk) <=
// K3_L1_MAX. Returns the CUDA error code of the launch (0 = launched).
int k3_astar(const float* hp, const float* hpn, const unsigned char* ov, const float* params,
             const float* cc, const unsigned char* cc_mask, const float* ends, const float* edge,
             int B, int N, const float* fconsts, const int* iconsts, float* g, float* f,
             float* px, float* py, float* pth, int* pp, float* cost, int* res, long long* tested,
             void* stream) {
  if (B <= 0) return 0;
  K3Consts k;
  K3Ints n;
  memcpy(&k, fconsts, sizeof(K3Consts));
  memcpy(&n, iconsts, sizeof(K3Ints));
  if (n.n_prims > K3_MAX_PRIMS || n.n_prims * n.n_cc > K3_MAX_POINTS || n.n_obs > K3_MAX_OBS ||
      N != n.nx * n.ny * n.ntheta || n.blk <= 0 || (n.blk & (n.blk - 1)) != 0 ||
      (N + n.blk - 1) / n.blk > K3_L1_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Key) * ((N + n.blk - 1) / n.blk);
  astar_kernel<<<B, K3_THREADS, smem, (cudaStream_t)stream>>>(
      hp, hpn, ov, params, cc, cc_mask, ends, edge, N, k, n, g, f, px, py, pth, pp, cost, res,
      tested);
  return (int)cudaGetLastError();
}

// CTAs of K3 that fit an SM with n_l1 level-1 entries, as the CUDA runtime
// counts them from registers and shared memory (negative: a CUDA error).
int k3_blocks_per_sm(int n_l1) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, astar_kernel, K3_THREADS, sizeof(Key) * n_l1);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
