"""Batched course planning on the device: the serial-A* engine.

Port of the A* half of ``mpc_for_av_at_intersection_tpu/lattice/wavefront.py``:
the grid configuration, the primitive tables the search needs, and
``plan_courses_device`` with its production engine, kernel K3
(``ops/astar.py``), followed by the backtrack through the parent/prim grid
and the exact replay of the primitive chain. The JAX package's top-F beam
engine (``wavefront_search``, kernel K4) is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.angles import normalize_angle
from ..models import VehicleGeometry
from ..mpc.controller import CUDA
from ..ops.astar import astar_search_batch
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


def grid_for(scenarios) -> WavefrontConfig:
    """The planner's serial-A* grid for these scenarios: 40 heading bins,
    32 above the budget; raises where the JAX package takes its beam engine."""
    cfg = WavefrontConfig.for_scenarios(scenarios, ntheta=40)
    if cfg.n_cells * _GRID_BYTES_PER_CELL > _GRID_BUDGET:
        cfg = WavefrontConfig.for_scenarios(scenarios, ntheta=32)
        if cfg.n_cells * _GRID_BYTES_PER_CELL > _GRID_BUDGET:
            raise NotImplementedError(
                "grid too large for the serial-A* engine; the JAX package falls back "
                "to its beam engine, not ported yet (ROADMAP queue 1, item 8)")
    return cfg


def plan_courses_device(
    scenarios,
    geom: VehicleGeometry,
    weights: SearchWeights | None = None,
    cfg: WavefrontConfig | None = None,
    margin: float | None = None,
    engine: str = "auto",
    max_expansions: int = 8192,
    device=CUDA,
) -> WavefrontResult:
    """Plan many scenarios' global courses in one batched search on
    ``device``: kernel K3 on the card, its plain version on the CPU.

    engine="astar" (or "auto"): the serial best-first search, one per
    scenario, with the host search's costs and goal-pop test.
    """
    from ..worlds.scenario import compile_scenario, stack_scenario_arrays

    if engine not in ("astar", "auto"):
        raise NotImplementedError(
            f"engine={engine!r}: only the serial-A* engine is ported; the beam engine "
            "and K4 wait for a later slice (ROADMAP queue 1, item 8)")
    if not isinstance(scenarios, (list, tuple)):
        scenarios = [scenarios]
    if margin is None:
        margin = geom.radius
    w = weights if weights is not None else SearchWeights.modified()

    if cfg is None:
        cfg = grid_for(scenarios)

    arrs = stack_scenario_arrays([compile_scenario(s, margin=margin) for s in scenarios])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    prims = prepare_primitives(primitive_table(geom), geom, np.float32)
    res = astar_search_batch(
        t(arrs.halfplanes), t(arrs.obstacle_valid, torch.bool), t(arrs.start),
        t(arrs.goal_point), t(arrs.goal_area_corners), t(arrs.goal_theta_tol),
        prims, cfg, w, max_expansions=max_expansions)
    start = t(arrs.start)
    traj, n_points, n_edges, ok = _backtrack_replay_batch(
        res.found, res.goal_cell, res.parent, res.prim, start, t(prims.points), cfg.max_edges)
    return WavefrontResult(
        found=ok, cost=torch.where(ok, res.cost, torch.full_like(res.cost, float("inf"))),
        trajectory=traj, n_points=n_points, n_edges=n_edges, oob=res.oob)


def _backtrack_replay_batch(found, goal_cell, parent, prim, start, points, E: int):
    """Walk the parent/prim grid from each popped goal cell and replay the
    exact continuous primitive chain from the start (reference
    path_to_full_trajectory, motion_primitive_search.py:123). Each edge
    contributes its first K-1 points. Returns (trajectory (B, E*(K-1)+1, 3),
    n_points, n_edges, ok), where ok is False for a chain that does not
    reach the start within E steps: the search may go deeper than
    ``max_edges``, and such a replay would be a corrupted prefix."""
    B = found.shape[0]
    K = points.shape[1]
    Km1 = K - 1
    dev = found.device
    rows = torch.arange(B, device=dev)
    i32 = torch.int32

    cell = torch.where(found, goal_cell, torch.full_like(goal_cell, -1)).to(torch.int64)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    seq = torch.full((B, E), -1, dtype=i32, device=dev)
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
