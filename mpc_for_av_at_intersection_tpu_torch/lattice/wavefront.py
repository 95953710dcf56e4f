"""Batched course planning on the device: the serial-A* and beam engines.

Port of ``mpc_for_av_at_intersection_tpu/lattice/wavefront.py``: the grid
configuration, the primitive tables the searches need, and
``plan_courses_device`` with its two engines, each followed by the
backtrack through the parent/prim grid and the exact replay of the
primitive chain:

- ``"astar"``, the production engine: kernel K3 (``ops/astar.py``), one
  serial best-first search per scenario;
- ``"beam"``: ``wavefront_search``, the top-F wavefront over a batch of
  scenarios in lockstep, its collision test kernel K4
  (``ops/collision.py``), one launch per iteration for the whole batch.
  The JAX package takes it where the serial-A* grid is over its budget.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.angles import hypot, normalize_angle
from ..models import VehicleGeometry
from ..mpc.controller import CUDA
from ..ops.astar import PI, TWO_PI, _wrap_pi, astar_search_batch
from ..ops.collision import frontier_collision, frontier_collision_reference, pack_collision
from .primitives import PrimitiveTable, primitive_table
from .search import SearchWeights, _resample_host


@dataclasses.dataclass(frozen=True)
class WavefrontConfig:
    x0: float = -48.0
    y0: float = -48.0
    nx: int = 96
    ny: int = 96
    ntheta: int = 32
    cell: float = 1.0
    frontier: int = 256      # beam width per iteration
    iters: int = 40
    max_edges: int = 32      # max primitives in a path
    h_theta: float = 2.7     # heuristic theta weight (modified preset)

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny * self.ntheta

    @staticmethod
    def for_scenarios(
        scenarios,
        cell: float = 1.0,
        ntheta: int = 32,
        frontier: int = 256,
        pad: float = 8.0,
        prim_len: float = 4.98,
        iters: int | None = None,
        max_edges: int | None = None,
        **kw,
    ) -> "WavefrontConfig":
        """Size the grid from the scenario geometry: the (x, y) extent is the
        union bounding box of all obstacles (boxes by corners, circles by
        center+-radius) plus every start/goal pose, padded by ``pad`` metres;
        the edge/iteration budgets scale with the box diameter in primitive
        lengths. Accepts one scenario or a batch (one grid for the batch)."""
        if not isinstance(scenarios, (list, tuple)):
            scenarios = [scenarios]
        lo = np.array([np.inf, np.inf])
        hi = np.array([-np.inf, -np.inf])

        def take(x, y):
            lo[0] = min(lo[0], x); lo[1] = min(lo[1], y)
            hi[0] = max(hi[0], x); hi[1] = max(hi[1], y)

        for sc in scenarios:
            take(sc.start[0], sc.start[1])
            take(sc.goal_point[0], sc.goal_point[1])
            x1, y1, x2, y2 = sc.goal_area.corners
            take(x1, y1); take(x2, y2)
            for o in sc.obstacles:
                if hasattr(o, "corners"):
                    x1, y1, x2, y2 = o.corners
                    take(x1, y1); take(x2, y2)
                else:
                    (cx, cy), r = o.center, o.radius
                    take(cx - r, cy - r); take(cx + r, cy + r)

        x0, y0 = float(lo[0] - pad), float(lo[1] - pad)
        nx = int(math.ceil((hi[0] + pad - x0) / cell))
        ny = int(math.ceil((hi[1] + pad - y0) / cell))
        diam = math.hypot(nx * cell, ny * cell)
        if max_edges is None:
            max_edges = max(24, int(math.ceil(1.2 * diam / prim_len)) + 4)
        if iters is None:
            iters = max_edges + 12
        return WavefrontConfig(
            x0=x0, y0=y0, nx=nx, ny=ny, ntheta=ntheta, cell=cell,
            frontier=frontier, iters=iters, max_edges=max_edges, **kw,
        )


class PrimitiveDeviceData(NamedTuple):
    """Primitive arrays of a search, numpy."""

    ends: np.ndarray       # (P, 3) endpoint pose in the parent frame
    lengths: np.ndarray    # (P,)
    cc: np.ndarray         # (P, C, 2) collision-check points (padded)
    cc_mask: np.ndarray    # (P, C)
    points: np.ndarray     # (P, K, 3) full arcs for trajectory replay


def prepare_primitives(table: PrimitiveTable, geom: VehicleGeometry, dtype=np.float32):
    """Pad the per-primitive collision points to a fixed count."""
    blocks = []
    centers = geom.circle_centers
    for p in range(table.n_primitives):
        pts = _resample_host(table.points[p], geom.radius)
        th = pts[:, 2]
        c, s = np.cos(th), np.sin(th)
        b = [
            np.stack([pts[:, 0] + c * ox - s * oy, pts[:, 1] + s * ox + c * oy], axis=1)
            for ox, oy in centers
        ]
        blocks.append(np.concatenate(b))
    C = max(len(b) for b in blocks)
    cc = np.zeros((table.n_primitives, C, 2))
    mask = np.zeros((table.n_primitives, C), bool)
    for p, b in enumerate(blocks):
        cc[p, : len(b)] = b
        mask[p, : len(b)] = True
    np_dtype = np.dtype(dtype)
    return PrimitiveDeviceData(
        ends=np.asarray(table.points[:, -1, :], np_dtype),
        lengths=np.asarray(table.lengths, np_dtype),
        cc=np.asarray(cc, np_dtype),
        cc_mask=np.asarray(mask, bool),
        points=np.asarray(table.points, np_dtype),
    )


class WavefrontResult(NamedTuple):
    found: torch.Tensor       # (B,) bool
    cost: torch.Tensor        # (B,)
    trajectory: torch.Tensor  # (B, max_edges*(K-1)+1, 3) padded
    n_points: torch.Tensor    # (B,) int32 valid length
    n_edges: torch.Tensor     # (B,) int32
    oob: torch.Tensor         # (B,) int32 — collision-free expansions pruned
    #                           for falling OUTSIDE the grid; nonzero with
    #                           found=False is the out-of-grid telltale


# The JAX package sizes the serial-A* grid to the TPU's VMEM: 40 heading
# bins, 32 when the grid's 28 bytes per cell exceed 80 MB, and its beam
# engine beyond that. The rule decides which courses come out, so the port
# keeps it unchanged although the card's grid lives in device memory.
_GRID_BYTES_PER_CELL = 28
_GRID_BUDGET = 80.0e6


def grid_for(scenarios, engine: str = "auto"):
    """(engine, grid) the planner uses for these scenarios: the serial-A*
    engine on 40 heading bins, 32 above the budget, and the beam engine on
    its own grid (32 bins, ``WavefrontConfig.for_scenarios``) where even
    the 32-bin grid is over it, or where ``engine="beam"`` asks for it."""
    if engine == "beam":
        return "beam", WavefrontConfig.for_scenarios(scenarios)
    cfg = WavefrontConfig.for_scenarios(scenarios, ntheta=40)
    if cfg.n_cells * _GRID_BYTES_PER_CELL > _GRID_BUDGET:
        cfg = WavefrontConfig.for_scenarios(scenarios, ntheta=32)
        if cfg.n_cells * _GRID_BYTES_PER_CELL > _GRID_BUDGET:
            return "beam", WavefrontConfig.for_scenarios(scenarios)
    return "astar", cfg


def plan_courses_device(
    scenarios,
    geom: VehicleGeometry,
    weights: SearchWeights | None = None,
    cfg: WavefrontConfig | None = None,
    margin: float | None = None,
    engine: str = "auto",
    max_expansions: int = 8192,
    collision: str = "auto",
    device=CUDA,
) -> WavefrontResult:
    """Plan many scenarios' global courses in one batched search on
    ``device``.

    engine="astar" (or "auto", the accelerator's choice in both packages):
    the serial best-first search, kernel K3 on the card, its plain version
    on the CPU; with no ``cfg`` it becomes the beam engine where the grid
    rule (``grid_for``) says so. engine="beam": ``wavefront_search``;
    ``collision`` picks its collision test (``"auto"``, ``"plain"`` or
    ``"kernel"``, see there).
    """
    from ..worlds.scenario import compile_scenario, stack_scenario_arrays

    if engine not in ("auto", "astar", "beam"):
        raise ValueError(f"unknown engine {engine!r}")
    if not isinstance(scenarios, (list, tuple)):
        scenarios = [scenarios]
    if margin is None:
        margin = geom.radius
    w = weights if weights is not None else SearchWeights.modified()

    if cfg is None:
        engine, cfg = grid_for(scenarios, engine)
    elif engine == "auto":
        engine = "astar"

    arrs = stack_scenario_arrays([compile_scenario(s, margin=margin) for s in scenarios])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    prims = prepare_primitives(primitive_table(geom), geom, np.float32)
    args = (t(arrs.halfplanes), t(arrs.obstacle_valid, torch.bool), t(arrs.start),
            t(arrs.goal_point), t(arrs.goal_area_corners), t(arrs.goal_theta_tol))
    if engine == "beam":
        return wavefront_search(*args, prims, cfg, weights=w, collision=collision)
    res = astar_search_batch(*args, prims, cfg, w, max_expansions=max_expansions)
    traj, n_points, n_edges, ok = _backtrack_replay_batch(
        res.found, res.goal_cell, res.parent, res.prim, args[2], t(prims.points), cfg.max_edges)
    return WavefrontResult(
        found=ok, cost=torch.where(ok, res.cost, torch.full_like(res.cost, float("inf"))),
        trajectory=traj, n_points=n_points, n_edges=n_edges, oob=res.oob)


def _f32(v) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    constant against a float32 array."""
    return float(np.float32(v))


_ORD_INF = 0x7F800000   # float32 bits of +inf: the key of a closed or unreached cell
_BIG = 2 ** 31 - 1


def _score_key(score, cell):
    """int64 keys that order (score, cell) lexicographically: the float32
    score's bits made order-preserving as an int32, above the cell index."""
    bits = (score + 0.0).view(torch.int32)          # -0.0 counts as +0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 32) | cell


def wavefront_search(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol,
                     prims: PrimitiveDeviceData, cfg: WavefrontConfig,
                     weights: SearchWeights | None = None,
                     collision: str = "auto") -> WavefrontResult:
    """The beam engine over a batch of scenarios in lockstep: halfplanes
    (B, O, H, 3), obstacle_valid (B, O), start/goal (B, 3), goal_box (B, 4),
    theta_tol (B,) on one device.

    Each of ``cfg.iters`` iterations takes every scenario's F open cells of
    least f = g + h (lowest cell index among equal f, as the JAX package's
    ``approx_min_k`` orders them on the CPU) and closes them, expands the 9
    primitives from their exact poses, tests the candidates for collision
    (``collision``: "auto" runs kernel K4 for CUDA tensors and its plain
    version for CPU ones, "plain" the plain version anywhere, "kernel" K4
    and raises for CPU tensors), counts collision-free candidates off the
    grid (oob), keeps the cheapest candidate inside the goal area, and
    writes each grid cell's best candidate (least g, then lowest candidate
    index) where it improves an open cell's g by more than 1e-6. A cell's
    record is frozen once it is closed, so the backtrack from the best goal
    candidate replays an exact primitive chain.

    The port keeps, per cell, the int64 key of (f, cell) that the top-F
    selection sorts, updated where a cell is written or closed, instead of
    re-evaluating the heuristic over the whole grid every iteration; the
    heuristic is a function of the stored pose, so the keys are the same.
    A chain longer than ``cfg.max_edges`` is reported as not found (the
    JAX package's replay of it would be a corrupted prefix).
    """
    if collision not in ("auto", "plain", "kernel"):
        raise ValueError(f"unknown collision {collision!r}")
    dev = start.device
    if collision == "kernel" and dev.type == "cpu":
        raise ValueError("collision='kernel' runs kernel K4 and needs CUDA tensors")
    collide = frontier_collision_reference if collision == "plain" else frontier_collision
    w = weights if weights is not None else SearchWeights(h_theta=cfg.h_theta)
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    inf = float("inf")

    hp = halfplanes.to(f32)
    B = hp.shape[0]
    P = prims.cc.shape[0]
    F, N = cfg.frontier, cfg.n_cells
    L = F * P
    packed = pack_collision(prims.cc, prims.cc_mask, hp, obstacle_valid)
    start, goal, goal_box = start.to(f32), goal.to(f32), goal_box.to(f32)
    gx, gy, gth = goal[:, 0:1], goal[:, 1:2], goal[:, 2:3]
    bx1, by1, bx2, by2 = (goal_box[:, i:i + 1] for i in range(4))
    tol = theta_tol.to(f32).reshape(B, 1)

    def host(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    ends, points = host(prims.ends), host(prims.points)
    ex, ey, et = ends[:, 0], ends[:, 1], ends[:, 2]
    edge = _f32(w.c_dist) * host(prims.lengths)
    if w.c_steering:
        edge = edge + _f32(w.c_steering) * torch.abs(_wrap_pi(ends[:, 2]))
    use_edge_obs = bool(w.c_obstacle) and ((not w.gate_edge_obstacle_on_h) or bool(w.h_obstacle))

    # 1 / (least distance to a half-plane boundary); padded rows have a
    # zero normal and are left out (multi_lane.py:78-108)
    hp_f = hp.reshape(B, -1, 3)
    hp_nrm = hypot(hp_f[..., 0], hp_f[..., 1])
    hp_live = hp_nrm > 1e-9
    hp_div = torch.where(hp_live, hp_nrm, torch.ones_like(hp_nrm))

    def obstacle_proximity(x, y):                   # (B, L) points
        out = torch.empty_like(x)
        step = max(1, (1 << 24) // max(x.shape[1] * hp_f.shape[1], 1))
        for lo in range(0, B, step):
            r = slice(lo, lo + step)
            a, b, c = (hp_f[r, None, :, i] for i in range(3))
            d = torch.abs(x[r, :, None] * a + y[r, :, None] * b + c) / hp_div[r, None, :]
            dmin = torch.where(hp_live[r, None, :], d, inf).amin(dim=-1)
            out[r] = 1.0 / torch.clamp(dmin, min=_f32(1e-9))
        return out

    def box_dist(px, py):
        dx = torch.maximum(torch.clamp(bx1 - px, min=0.0), px - bx2)
        dy = torch.maximum(torch.clamp(by1 - py, min=0.0), py - by2)
        return torch.sqrt(dx * dx + dy * dy)

    def heuristic(px, py, pth, prox):
        adth = torch.abs(pth - gth)
        if w.heuristic_mode == "area":
            h = box_dist(px, py) + _f32(2.7) * torch.clamp(adth - tol, min=0.0)
        else:
            d = hypot(px - gx, py - gy)
            dth = torch.minimum(adth, adth - tol / 2.0)
            h = _f32(w.h_dist) * d + _f32(w.h_theta) * dth
        if w.h_steering:
            h = h + _f32(w.h_steering) * torch.abs(_wrap_pi(gth - pth))
        if w.h_obstacle:
            h = h + _f32(w.h_obstacle) * prox
        if w.h_center:
            h = h + _f32(w.h_center) * hypot(px, py)
        return h

    x0, y0, cell = _f32(cfg.x0), _f32(cfg.y0), _f32(cfg.cell)
    x_hi, y_hi = _f32(cfg.x0 + cfg.nx * cfg.cell), _f32(cfg.y0 + cfg.ny * cfg.cell)
    bin_w = _f32(2 * math.pi / cfg.ntheta)

    def cell_index(px, py, pth):
        ix = torch.clamp(torch.floor((px - x0) / cell), 0, cfg.nx - 1).to(i64)
        iy = torch.clamp(torch.floor((py - y0) / cell), 0, cfg.ny - 1).to(i64)
        th = torch.remainder(pth + PI, TWO_PI)
        it = torch.clamp(torch.floor(th / bin_w), 0, cfg.ntheta - 1).to(i64)
        return ix * (cfg.ny * cfg.ntheta) + iy * cfg.ntheta + it

    # grid state; key orders the open cells by (f, cell) for the selection
    key = (torch.arange(N, dtype=i64, device=dev) | (_ORD_INF << 32)).repeat(B, 1)
    g = torch.full((B, N), inf, dtype=f32, device=dev)
    pose = torch.zeros((B, N, 3), dtype=f32, device=dev)
    parent = torch.full((B, N), -1, dtype=i32, device=dev)
    prim = torch.full((B, N), -1, dtype=i32, device=dev)
    closed = torch.zeros((B, N), dtype=torch.bool, device=dev)
    g_min = torch.full((B, N), inf, dtype=f32, device=dev)         # scatter scratch
    upd = torch.full((B, N), _BIG, dtype=i32, device=dev)

    rows = torch.arange(B, device=dev)
    sx, sy, sth = start[:, 0:1], start[:, 1:2], start[:, 2:3]
    sc = cell_index(sx, sy, sth)
    prox0 = obstacle_proximity(sx, sy) if w.h_obstacle else None
    g.scatter_(1, sc, 0.0)
    pose[rows, sc[:, 0]] = start
    key.scatter_(1, sc, _score_key(0.0 + heuristic(sx, sy, sth, prox0), sc))

    bg_g = torch.full((B,), inf, dtype=f32, device=dev)
    bg_parent = torch.full((B,), -1, dtype=i64, device=dev)
    bg_prim = torch.full((B,), -1, dtype=i64, device=dev)
    oob = torch.zeros((B,), dtype=i32, device=dev)
    cand_idx = torch.arange(L, dtype=i32, device=dev)

    for _ in range(cfg.iters):
        # --- the F open cells of least (f, cell); close them ---
        kv, idxs = torch.topk(key, F, dim=1, largest=False, sorted=True)
        active = (kv >> 32) < _ORD_INF
        closed.scatter_(1, idxs, closed.gather(1, idxs) | active)
        key.scatter_(1, idxs, idxs | (_ORD_INF << 32))
        ep = pose[rows[:, None], idxs]                              # (B, F, 3)
        eg = g.gather(1, idxs)

        # --- F x P candidates, flattened f-major as (B, F*P) ---
        c, s = torch.cos(ep[..., 2:3]), torch.sin(ep[..., 2:3])
        nxp = (ep[..., 0:1] + c * ex - s * ey).reshape(B, L)
        nyp = (ep[..., 1:2] + s * ex + c * ey).reshape(B, L)
        nth = normalize_angle(et + ep[..., 2:3]).reshape(B, L)
        cg = (eg[..., None] + edge).reshape(B, L)
        prox = obstacle_proximity(nxp, nyp) if (use_edge_obs or w.h_obstacle) else None
        if use_edge_obs:
            cg = cg + _f32(w.c_obstacle) * prox
        if w.c_center:
            cg = cg + _f32(w.c_center) * hypot(nxp, nyp)

        hit = collide(ep.contiguous(), packed).reshape(B, L)
        inb = (nxp >= x0) & (nxp < x_hi) & (nyp >= y0) & (nyp < y_hi)
        free = active.repeat_interleave(P, dim=1) & ~hit
        oob += (free & ~inb).sum(dim=1).to(i32)
        valid = free & inb

        # --- goal tracking: the cheapest candidate inside the goal area ---
        goal_ok = valid & (box_dist(nxp, nyp) <= _f32(1e-5)) & (torch.abs(nth - gth) <= tol)
        gg = torch.where(goal_ok, cg, inf)
        flat = gg.argmin(dim=1)
        g_best = gg[rows, flat]
        better = g_best < bg_g
        bg_g = torch.where(better, g_best, bg_g)
        bg_parent = torch.where(better, idxs[rows, flat // P], bg_parent)
        bg_prim = torch.where(better, flat % P, bg_prim)

        # --- dedup: per cell, the least g, then the lowest candidate index ---
        keys = cell_index(nxp, nyp, nth)
        ok = valid & ~closed.gather(1, keys) & (cg < g.gather(1, keys) - _f32(1e-6))
        g_min.scatter_reduce_(1, keys, torch.where(ok, cg, inf), "amin", include_self=True)
        win = ok & (cg <= g_min.gather(1, keys))
        upd.scatter_reduce_(1, keys, torch.where(win, cand_idx, _BIG), "amin", include_self=True)
        bi, ji = torch.nonzero(upd.gather(1, keys) == cand_idx, as_tuple=True)
        g_min.scatter_(1, keys, inf)
        upd.scatter_(1, keys, _BIG)

        cells = keys[bi, ji]
        h = heuristic(nxp, nyp, nth, prox)
        g[bi, cells] = cg[bi, ji]
        pose[bi, cells] = torch.stack([nxp[bi, ji], nyp[bi, ji], nth[bi, ji]], dim=-1)
        parent[bi, cells] = idxs[bi, ji // P].to(i32)
        prim[bi, cells] = (ji % P).to(i32)
        key[bi, cells] = _score_key(cg[bi, ji] + h[bi, ji], cells)

    found = torch.isfinite(bg_g)
    traj, n_points, n_edges, ok = _backtrack_replay_batch(
        found, bg_parent, parent, prim, start, points, cfg.max_edges, goal_prim=bg_prim)
    return WavefrontResult(
        found=ok, cost=torch.where(ok, bg_g, torch.full_like(bg_g, inf)), trajectory=traj,
        n_points=n_points, n_edges=n_edges, oob=oob)


def _backtrack_replay_batch(found, goal_cell, parent, prim, start, points, E: int,
                            goal_prim=None):
    """Walk the parent/prim grid from each goal cell and replay the exact
    continuous primitive chain from the start (reference
    path_to_full_trajectory, motion_primitive_search.py:123). Each edge
    contributes its first K-1 points. ``goal_prim`` is the beam engine's:
    its goal is a candidate, not a cell, so the walk starts at the goal
    candidate's parent cell with the goal primitive as the chain's last
    edge. Returns (trajectory (B, E*(K-1)+1, 3), n_points, n_edges, ok),
    where ok is False for a chain that does not reach the start within E
    steps: such a replay would be a corrupted prefix."""
    B = found.shape[0]
    K = points.shape[1]
    Km1 = K - 1
    dev = found.device
    rows = torch.arange(B, device=dev)
    i32 = torch.int32

    cell = torch.where(found, goal_cell, torch.full_like(goal_cell, -1)).to(torch.int64)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    seq = torch.full((B, E), -1, dtype=i32, device=dev)
    if goal_prim is not None:
        first = found & (goal_prim >= 0)
        seq[:, 0] = torch.where(first, goal_prim, -1).to(i32)
        k = first.to(torch.int64)
    for _ in range(E):
        has = cell >= 0
        safe = torch.clamp(cell, min=0)
        p_here = torch.where(has, prim[rows, safe], torch.full_like(k, -1, dtype=i32))
        put = has & (p_here >= 0)
        slot = torch.clamp(k, max=E - 1)
        seq[rows, slot] = torch.where(put, p_here, seq[rows, slot])
        k = k + put.to(torch.int64)
        cell = torch.where(has, parent[rows, safe].to(torch.int64), torch.full_like(cell, -1))
    complete = cell < 0
    ok = found & complete
    n_edges = torch.where(ok, k, torch.zeros_like(k))

    e = torch.arange(E, device=dev)
    idx = torch.clamp(n_edges[:, None] - 1 - e[None, :], 0, E - 1)
    seq_fwd = torch.where(e[None, :] < n_edges[:, None], torch.gather(seq, 1, idx),
                          torch.full_like(seq, -1))

    pose = start.clone()
    out = torch.zeros((B, E * Km1 + 1, 3), dtype=start.dtype, device=dev)
    for j in range(E):
        p = seq_fwd[:, j]
        use = p >= 0
        pts = points[torch.clamp(p, min=0).to(torch.int64)]             # (B, K, 3)
        cth, sth = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
        world = torch.stack([
            pose[:, 0:1] + cth * pts[..., 0] - sth * pts[..., 1],
            pose[:, 1:2] + sth * pts[..., 0] + cth * pts[..., 1],
            pts[..., 2] + pose[:, 2:3],
        ], dim=-1)
        seg = out[:, j * Km1:(j + 1) * Km1]
        out[:, j * Km1:(j + 1) * Km1] = torch.where(use[:, None, None], world[:, :Km1], seg)
        nxt = torch.stack([world[:, -1, 0], world[:, -1, 1], normalize_angle(world[:, -1, 2])], -1)
        pose = torch.where(use[:, None], nxt, pose)
    return out, (n_edges * Km1).to(i32), n_edges.to(i32), ok
