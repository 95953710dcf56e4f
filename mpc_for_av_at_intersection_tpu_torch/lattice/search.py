"""Lattice search over motion primitives with a unified weighted-cost API.

A copy of ``mpc_for_av_at_intersection_tpu/lattice/search.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

One parameterized search subsumes the reference's five near-copy variants
(``main/lib/motion_primitive_search*.py``):

- `modified` preset  -> point-goal heuristic, length-only edge cost
  (motion_primitive_search_modified.py — the variant the MPC drivers use);
- `base` preset      -> goal-AREA heuristic (motion_primitive_search.py);
- `single_lane`, `roundabout`, and the fully weighted multi-lane variant
  are weight vectors over the same five heuristic terms and four edge-cost
  terms (motion_primitive_search_multi_lane.py:21-25 — the most general
  form, whose term definitions we adopt).

Reference quirks kept: the edge obstacle term is gated on the *heuristic*
obstacle weight (multi_lane.py:230 checks `wh_obstacle`), and the edge
center term on `wc_center`.

This host-side implementation is the exact-search oracle (and the seed-path
producer for the engine); collision checks are vectorized across ALL
obstacles and half-planes at once instead of the reference's per-obstacle
short-circuit loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from ..models import VehicleGeometry
from ..worlds.scenario import Scenario
from .astar import AStar
from .primitives import PrimitiveTable

Node = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class SearchWeights:
    h_dist: float = 1.0
    h_theta: float = 2.7
    h_steering: float = 0.0
    h_obstacle: float = 0.0
    h_center: float = 0.0
    c_dist: float = 1.0
    c_steering: float = 0.0
    c_obstacle: float = 0.0
    c_center: float = 0.0
    heuristic_mode: str = "point"  # "point" (modified) or "area" (base)
    # reference multi_lane.py:230 gates the EDGE obstacle term on the
    # HEURISTIC obstacle weight; the single-lane/roundabout variants compute
    # it unconditionally (their own hard-coded files)
    gate_edge_obstacle_on_h: bool = True

    @staticmethod
    def modified() -> "SearchWeights":
        return SearchWeights()

    @staticmethod
    def base() -> "SearchWeights":
        return SearchWeights(heuristic_mode="area")

    @staticmethod
    def single_lane() -> "SearchWeights":
        return SearchWeights(
            h_steering=15.0, c_steering=5.0, c_obstacle=0.1,
            gate_edge_obstacle_on_h=False,
        )

    @staticmethod
    def roundabout() -> "SearchWeights":
        return SearchWeights(
            c_steering=5.0, c_obstacle=0.1, gate_edge_obstacle_on_h=False
        )

    @staticmethod
    def multi_lane(**kw) -> "SearchWeights":
        """Reference multi-lane defaults (multi_lane.py:23-25)."""
        base = dict(h_steering=15.0, c_steering=5.0, c_obstacle=0.1)
        base.update(kw)
        return SearchWeights(**base)


def _wrap_pi(a: float) -> float:
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def _resample_host(points: np.ndarray, dl: float) -> np.ndarray:
    seg = np.linalg.norm(np.diff(points[:, :2], axis=0), axis=1)
    q = np.floor(np.append(0.0, seg).cumsum() / dl).astype(int)
    mask = np.append(True, (q[1:] - q[:-1]) >= 1)
    mask[-1] = True
    return points[mask]


class MotionPrimitiveSearch:
    """Host-side exact lattice search. Nodes are continuous (x, y, theta)."""

    def __init__(
        self,
        scenario: Scenario,
        geom: VehicleGeometry,
        table: PrimitiveTable,
        margin: float,
        weights: SearchWeights = SearchWeights.modified(),
    ):
        self._geom = geom
        self._table = table
        self._w = weights
        self._start: Node = tuple(float(v) for v in scenario.start)
        self._goal: Node = tuple(float(v) for v in scenario.goal_point)
        self._goal_area = scenario.goal_area
        self._theta_tol = float(scenario.allowed_goal_theta_difference)
        self._edge_mp: Dict[Tuple[Node, Node], int] = {}

        # stacked half-planes (sum_H, 3) + segment ids per obstacle
        hp_blocks = [o.halfplanes(margin=margin) for o in scenario.obstacles]
        if hp_blocks:
            self._hp = np.concatenate(hp_blocks, axis=0)
            self._hp_obstacle = np.repeat(
                np.arange(len(hp_blocks)), [len(b) for b in hp_blocks]
            )
            self._n_obstacles = len(hp_blocks)
        else:
            self._hp = np.zeros((0, 3))
            self._hp_obstacle = np.zeros((0,), int)
            self._n_obstacles = 0
        self._hp_norm = np.linalg.norm(self._hp[:, :2], axis=1) if len(self._hp) else None

        # collision-check points per primitive: decimate at circle-radius
        # spacing, then expand to circle-center trajectories
        self._cc_points: List[np.ndarray] = []
        cc = geom.circle_centers
        for p in range(table.n_primitives):
            pts = _resample_host(table.points[p], geom.radius)
            th = pts[:, 2]
            c, s = np.cos(th), np.sin(th)
            blocks = []
            for ox, oy in cc:
                blocks.append(
                    np.stack(
                        [pts[:, 0] + c * ox - s * oy, pts[:, 1] + s * ox + c * oy],
                        axis=1,
                    )
                )
            self._cc_points.append(np.concatenate(blocks, axis=0))

        self._a_star: AStar[Node] = AStar(self.neighbors)

    # --- goal / heuristic -------------------------------------------------
    def is_goal(self, node: Node) -> bool:
        return (
            self._goal_area.distance_to_point(node[:2]) <= 1e-5
            and abs(node[2] - self._goal[2]) <= self._theta_tol
        )

    def _obstacle_proximity(self, x: float, y: float) -> float:
        """1 / (min distance to any obstacle half-plane boundary)
        (multi_lane.py:78-108)."""
        if self._n_obstacles == 0:
            return 0.0
        d = np.abs(self._hp[:, 0] * x + self._hp[:, 1] * y + self._hp[:, 2]) / self._hp_norm
        dmin = float(d.min())
        return 1.0 / dmin if dmin else float("inf")

    def heuristic(self, node: Node) -> float:
        x, y, th = node
        w = self._w
        if w.heuristic_mode == "area":
            dist = self._goal_area.distance_to_point((x, y))
            dth = max(0.0, abs(th - self._goal[2]) - self._theta_tol)
            return dist + 2.7 * dth
        gx, gy, gth = self._goal
        dist = math.hypot(x - gx, y - gy)
        dth = min(abs(th - gth), abs(th - gth) - self._theta_tol / 2.0)
        h = w.h_dist * dist + w.h_theta * dth
        if w.h_steering:
            h += w.h_steering * abs(_wrap_pi(gth - th))
        if w.h_obstacle:
            h += w.h_obstacle * self._obstacle_proximity(x, y)
        if w.h_center:
            h += w.h_center * math.hypot(x, y)
        return h

    # --- expansion --------------------------------------------------------
    def _collides(self, pts_xy: np.ndarray) -> bool:
        if self._n_obstacles == 0:
            return False
        vals = pts_xy @ self._hp[:, :2].T + self._hp[:, 2]  # (n_pts, sum_H)
        inside = vals <= 0.0
        # a point collides with obstacle o iff ALL of o's rows hold
        per_obs_all = np.logical_and.reduceat(
            inside, np.searchsorted(self._hp_obstacle, np.arange(self._n_obstacles)), axis=1
        )
        return bool(per_obs_all.any())

    def neighbors(self, node: Node):
        x0, y0, th0 = node
        c, s = math.cos(th0), math.sin(th0)
        w = self._w
        tbl = self._table
        for p in range(tbl.n_primitives):
            cc = self._cc_points[p]
            pts_xy = np.stack(
                [x0 + c * cc[:, 0] - s * cc[:, 1], y0 + s * cc[:, 0] + c * cc[:, 1]],
                axis=1,
            )
            if self._collides(pts_xy):
                continue
            ex, ey, eth = tbl.points[p, -1]
            nx = x0 + c * ex - s * ey
            ny = y0 + s * ex + c * ey
            # normalize to [-pi, pi) like reference maths.normalize_angle
            t = (eth + th0) % (2.0 * math.pi)
            if t >= math.pi:
                t -= 2.0 * math.pi
            nbr: Node = (nx, ny, t)
            self._edge_mp[(node, nbr)] = p

            cost = w.c_dist * float(tbl.lengths[p])
            if w.c_steering:
                cost += w.c_steering * abs(_wrap_pi(t - th0))
            use_edge_obs = w.c_obstacle and (
                (not w.gate_edge_obstacle_on_h) or w.h_obstacle
            )
            if use_edge_obs:
                cost += w.c_obstacle * self._obstacle_proximity(nx, ny)
            if w.c_center:
                cost += w.c_center * math.hypot(nx, ny)
            yield cost, nbr

    # --- driver -----------------------------------------------------------
    def run(self, debug: bool = False):
        cost, path = self._a_star.run(
            self._start, self.is_goal, self.heuristic, debug=debug
        )
        return cost, path, self.path_to_trajectory(path)

    @property
    def debug_data(self):
        return self._a_star.debug_data

    def path_to_trajectory(self, path: List[Node]) -> np.ndarray:
        chunks = []
        for a, b in zip(path[:-1], path[1:]):
            p = self._edge_mp[(a, b)]
            pts = self._table.points[p][:-1]
            x0, y0, th0 = a
            c, s = math.cos(th0), math.sin(th0)
            world = np.stack(
                [
                    x0 + c * pts[:, 0] - s * pts[:, 1],
                    y0 + s * pts[:, 0] + c * pts[:, 1],
                    pts[:, 2] + th0,
                ],
                axis=1,
            )
            chunks.append(world)
        return np.concatenate(chunks, axis=0)
