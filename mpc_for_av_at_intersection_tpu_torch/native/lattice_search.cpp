// Native lattice A* core — the host-side planner hot loop.
//
// Same contract as the Python search in ../lattice/search.py (which remains
// the readable oracle): continuous (x, y, theta) nodes, 9 motion-primitive
// edges, union-of-half-plane collision pruning, weighted heuristic/edge
// costs. Heap ordering replicates Python heapq's lexicographic tuple
// comparison ((f, g, node, pred)) so expansion order — and therefore the
// returned path — matches the Python implementation bit for bit when the
// arithmetic does (identical libm calls, identical formula order).
//
// Built as a plain C ABI shared object; bound via ctypes (no pybind11 in
// this environment).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

constexpr double TAU = 6.283185307179586476925286766559;

struct Node {
  double x, y, t;
  bool operator==(const Node& o) const { return x == o.x && y == o.y && t == o.t; }
};

struct NodeHash {
  size_t operator()(const Node& n) const {
    // hash the exact bit patterns (we rely on exact float equality, like
    // the Python dict over float tuples)
    uint64_t a, b, c;
    std::memcpy(&a, &n.x, 8);
    std::memcpy(&b, &n.y, 8);
    std::memcpy(&c, &n.t, 8);
    uint64_t h = a * 0x9E3779B97F4A7C15ull;
    h ^= b + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    h ^= c + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    return static_cast<size_t>(h);
  }
};

struct HeapItem {
  double f, g;
  Node node, pred;
  int via_prim;  // primitive index taken to reach `node` (-1 for start)
};

// min-heap with Python-tuple ordering: (f, g, node.xyt, pred.xyt)
struct HeapCmp {
  bool operator()(const HeapItem& a, const HeapItem& b) const {
    if (a.f != b.f) return a.f > b.f;
    if (a.g != b.g) return a.g > b.g;
    if (a.node.x != b.node.x) return a.node.x > b.node.x;
    if (a.node.y != b.node.y) return a.node.y > b.node.y;
    if (a.node.t != b.node.t) return a.node.t > b.node.t;
    if (a.pred.x != b.pred.x) return a.pred.x > b.pred.x;
    if (a.pred.y != b.pred.y) return a.pred.y > b.pred.y;
    return a.pred.t > b.pred.t;
  }
};

double normalize_angle(double t) {
  t = std::fmod(t, TAU);
  if (t < 0) t += TAU;  // Python %: result has the divisor's sign
  if (t >= M_PI) t -= TAU;
  return t;
}

double wrap_pi(double a) {
  a = std::fmod(a + M_PI, TAU);
  if (a < 0) a += TAU;
  return a - M_PI;
}

struct Weights {
  double h_dist, h_theta, h_steer, h_obst, h_center;
  double c_dist, c_steer, c_obst, c_center;
  int heuristic_area;   // 0 = point-goal, 1 = goal-area
  int gate_edge_on_h;   // multi-lane quirk: edge obstacle term gated on h_obst
};

struct Problem {
  int n_prims;
  const double* prim_end;      // P x 3
  const double* prim_lengths;  // P
  const double* cc_points;     // sumC x 2 (per-primitive blocks)
  const int64_t* cc_offsets;   // P+1
  const double* halfplanes;    // sumH x 3
  const int64_t* hp_offsets;   // O+1
  int n_obstacles;
  double gx, gy, gt;
  double bx1, by1, bx2, by2;  // goal area box
  double theta_tol;
  Weights w;
};

double box_distance(const Problem& p, double x, double y) {
  double dx = std::fmax(std::fmax(p.bx1 - x, 0.0), x - p.bx2);
  double dy = std::fmax(std::fmax(p.by1 - y, 0.0), y - p.by2);
  return std::sqrt(dx * dx + dy * dy);
}

bool is_goal(const Problem& p, const Node& n) {
  return box_distance(p, n.x, n.y) <= 1e-5 &&
         std::fabs(n.t - p.gt) <= p.theta_tol;
}

double obstacle_proximity(const Problem& p, double x, double y) {
  if (p.n_obstacles == 0) return 0.0;
  const int64_t n_rows = p.hp_offsets[p.n_obstacles];
  double dmin = INFINITY;
  for (int64_t r = 0; r < n_rows; ++r) {
    const double a = p.halfplanes[3 * r], b = p.halfplanes[3 * r + 1],
                 c = p.halfplanes[3 * r + 2];
    const double d = std::fabs(a * x + b * y + c) / std::sqrt(a * a + b * b);
    if (d < dmin) dmin = d;
  }
  return dmin == 0.0 ? INFINITY : 1.0 / dmin;
}

double heuristic(const Problem& p, const Node& n) {
  const Weights& w = p.w;
  if (w.heuristic_area) {
    const double dist = box_distance(p, n.x, n.y);
    const double dth = std::fmax(0.0, std::fabs(n.t - p.gt) - p.theta_tol);
    return dist + 2.7 * dth;
  }
  const double dist = std::hypot(n.x - p.gx, n.y - p.gy);
  const double adth = std::fabs(n.t - p.gt);
  const double dth = std::fmin(adth, adth - p.theta_tol / 2.0);
  double h = w.h_dist * dist + w.h_theta * dth;
  if (w.h_steer != 0.0) h += w.h_steer * std::fabs(wrap_pi(p.gt - n.t));
  if (w.h_obst != 0.0) h += w.h_obst * obstacle_proximity(p, n.x, n.y);
  if (w.h_center != 0.0) h += w.h_center * std::hypot(n.x, n.y);
  return h;
}

// does primitive `pi`, placed at `n`, collide with any obstacle?
bool collides(const Problem& p, int pi, const Node& n, double c, double s,
              std::vector<double>& scratch) {
  const int64_t c0 = p.cc_offsets[pi], c1 = p.cc_offsets[pi + 1];
  const int64_t n_pts = c1 - c0;
  scratch.resize(2 * n_pts);
  for (int64_t k = 0; k < n_pts; ++k) {
    const double px = p.cc_points[2 * (c0 + k)], py = p.cc_points[2 * (c0 + k) + 1];
    scratch[2 * k] = n.x + c * px - s * py;
    scratch[2 * k + 1] = n.y + s * px + c * py;
  }
  for (int o = 0; o < p.n_obstacles; ++o) {
    const int64_t h0 = p.hp_offsets[o], h1 = p.hp_offsets[o + 1];
    for (int64_t k = 0; k < n_pts; ++k) {
      bool inside = true;
      for (int64_t r = h0; r < h1; ++r) {
        const double v = p.halfplanes[3 * r] * scratch[2 * k] +
                         p.halfplanes[3 * r + 1] * scratch[2 * k + 1] +
                         p.halfplanes[3 * r + 2];
        if (v > 0.0) { inside = false; break; }
      }
      if (inside) return true;  // any point inside this obstacle
    }
  }
  return false;
}

}  // namespace

extern "C" int lattice_search(
    // primitives
    int n_prims, const double* prim_end, const double* prim_lengths,
    const double* cc_points, const int64_t* cc_offsets,
    // obstacles
    const double* halfplanes, const int64_t* hp_offsets, int n_obstacles,
    // problem
    const double* start3, const double* goal3, const double* goal_box4,
    double theta_tol,
    // weights: h_dist,h_theta,h_steer,h_obst,h_center,
    //          c_dist,c_steer,c_obst,c_center, area_mode, gate_flag
    const double* weights11,
    // limits
    int64_t max_expansions,
    // outputs
    double* out_nodes /* max_path x 3 */, int32_t* out_prims /* max_path */,
    int32_t max_path, int32_t* out_n_path, double* out_cost,
    int64_t* out_expansions) {
  Problem p;
  p.n_prims = n_prims;
  p.prim_end = prim_end;
  p.prim_lengths = prim_lengths;
  p.cc_points = cc_points;
  p.cc_offsets = cc_offsets;
  p.halfplanes = halfplanes;
  p.hp_offsets = hp_offsets;
  p.n_obstacles = n_obstacles;
  p.gx = goal3[0]; p.gy = goal3[1]; p.gt = goal3[2];
  p.bx1 = goal_box4[0]; p.by1 = goal_box4[1];
  p.bx2 = goal_box4[2]; p.by2 = goal_box4[3];
  p.theta_tol = theta_tol;
  p.w = Weights{weights11[0], weights11[1], weights11[2], weights11[3],
                weights11[4], weights11[5], weights11[6], weights11[7],
                weights11[8], (int)weights11[9], (int)weights11[10]};

  const Node start{start3[0], start3[1], start3[2]};
  std::priority_queue<HeapItem, std::vector<HeapItem>, HeapCmp> heap;
  heap.push(HeapItem{0.0, 0.0, start, start, -1});

  struct Best { double g; Node pred; int via_prim; };
  std::unordered_map<Node, Best, NodeHash> best;
  best.reserve(1 << 16);

  std::vector<double> scratch;
  int64_t expansions = 0;

  const bool use_edge_obs =
      p.w.c_obst != 0.0 && (!p.w.gate_edge_on_h || p.w.h_obst != 0.0);

  while (!heap.empty()) {
    HeapItem it = heap.top();
    heap.pop();
    auto found = best.find(it.node);
    if (found != best.end() && it.g >= found->second.g) continue;
    best[it.node] = Best{it.g, it.pred, it.via_prim};
    ++expansions;
    if (expansions > max_expansions) return -2;  // effort budget exceeded

    if (is_goal(p, it.node)) {
      // reconstruct (start .. goal), then write forward
      std::vector<Node> rev;
      std::vector<int> rev_prims;
      Node n = it.node;
      Node pred = it.pred;
      rev.push_back(n);
      rev_prims.push_back(best[n].via_prim);
      while (!(n == start)) {
        n = pred;
        const Best& b = best[n];
        pred = b.pred;
        rev.push_back(n);
        rev_prims.push_back(b.via_prim);
      }
      const int len = (int)rev.size();
      if (len > max_path) return -3;
      for (int i = 0; i < len; ++i) {
        const Node& nn = rev[len - 1 - i];
        out_nodes[3 * i] = nn.x;
        out_nodes[3 * i + 1] = nn.y;
        out_nodes[3 * i + 2] = nn.t;
        out_prims[i] = rev_prims[len - 1 - i];  // primitive INTO node i
      }
      *out_n_path = len;
      *out_cost = it.g;
      *out_expansions = expansions;
      return 0;
    }

    const double c = std::cos(it.node.t), s = std::sin(it.node.t);
    for (int pi = 0; pi < n_prims; ++pi) {
      if (collides(p, pi, it.node, c, s, scratch)) continue;
      const double ex = prim_end[3 * pi], ey = prim_end[3 * pi + 1],
                   et = prim_end[3 * pi + 2];
      Node nbr;
      nbr.x = it.node.x + c * ex - s * ey;
      nbr.y = it.node.y + s * ex + c * ey;
      nbr.t = normalize_angle(et + it.node.t);

      double cost = p.w.c_dist * prim_lengths[pi];
      if (p.w.c_steer != 0.0)
        cost += p.w.c_steer * std::fabs(wrap_pi(nbr.t - it.node.t));
      if (use_edge_obs)
        cost += p.w.c_obst * obstacle_proximity(p, nbr.x, nbr.y);
      if (p.w.c_center != 0.0) cost += p.w.c_center * std::hypot(nbr.x, nbr.y);

      const double ng = it.g + cost;
      auto fb = best.find(nbr);
      if (fb == best.end() || ng < fb->second.g) {
        heap.push(HeapItem{ng + heuristic(p, nbr), ng, nbr, it.node, pi});
      }
    }
  }
  return -1;  // no path
}
