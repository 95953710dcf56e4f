"""ctypes front-end for the native lattice search (port of
``mpc_for_av_at_intersection_tpu/native/search.py``).

Drop-in for ``lattice.MotionPrimitiveSearch`` (same constructor shape, same
``run()`` contract); the Python implementation remains the oracle and the
fallback when no C++ toolchain is present.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import numpy as np

from ..lattice.primitives import PrimitiveTable
from ..lattice.search import SearchWeights, _resample_host
from ..lattice.astar import NoPathError
from ..models import VehicleGeometry
from ..worlds.scenario import Scenario
from .build import load_native

Node = Tuple[float, float, float]


class NativeMotionPrimitiveSearch:
    def __init__(
        self,
        scenario: Scenario,
        geom: VehicleGeometry,
        table: PrimitiveTable,
        margin: float,
        weights: SearchWeights = SearchWeights.modified(),
        max_expansions: int = 2_000_000,
        max_path: int = 512,
    ):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native search unavailable (no g++?)")
        self._lib = lib
        self._table = table
        self._w = weights
        self._max_expansions = max_expansions
        self._max_path = max_path
        self.n_expanded = 0

        self._start = np.asarray(scenario.start, np.float64)
        self._goal = np.asarray(scenario.goal_point, np.float64)
        self._goal_box = np.asarray(scenario.goal_area.corners, np.float64)
        self._theta_tol = float(scenario.allowed_goal_theta_difference)

        hp_blocks = [o.halfplanes(margin=margin) for o in scenario.obstacles]
        if hp_blocks:
            self._hp = np.ascontiguousarray(np.concatenate(hp_blocks), np.float64)
            self._hp_off = np.concatenate(
                [[0], np.cumsum([len(b) for b in hp_blocks])]
            ).astype(np.int64)
        else:
            self._hp = np.zeros((0, 3), np.float64)
            self._hp_off = np.zeros((1,), np.int64)
        self._n_obstacles = len(hp_blocks)

        # collision points per primitive, flattened
        cc_blocks = []
        cc = geom.circle_centers
        for p in range(table.n_primitives):
            pts = _resample_host(table.points[p], geom.radius)
            th = pts[:, 2]
            c, s = np.cos(th), np.sin(th)
            blocks = [
                np.stack(
                    [pts[:, 0] + c * ox - s * oy, pts[:, 1] + s * ox + c * oy],
                    axis=1,
                )
                for ox, oy in cc
            ]
            cc_blocks.append(np.concatenate(blocks))
        self._cc = np.ascontiguousarray(np.concatenate(cc_blocks), np.float64)
        self._cc_off = np.concatenate(
            [[0], np.cumsum([len(b) for b in cc_blocks])]
        ).astype(np.int64)

        self._prim_end = np.ascontiguousarray(table.points[:, -1, :], np.float64)
        self._prim_len = np.ascontiguousarray(table.lengths, np.float64)

    def run(self, debug: bool = False):
        w = self._w
        weights11 = np.asarray(
            [
                w.h_dist, w.h_theta, w.h_steering, w.h_obstacle, w.h_center,
                w.c_dist, w.c_steering, w.c_obstacle, w.c_center,
                1.0 if w.heuristic_mode == "area" else 0.0,
                1.0 if w.gate_edge_obstacle_on_h else 0.0,
            ],
            np.float64,
        )
        out_nodes = np.zeros((self._max_path, 3), np.float64)
        out_prims = np.zeros((self._max_path,), np.int32)
        n_path = ctypes.c_int32(0)
        cost = ctypes.c_double(0.0)
        expansions = ctypes.c_int64(0)

        def dp(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

        def ip64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        rc = self._lib.lattice_search(
            self._table.n_primitives, dp(self._prim_end), dp(self._prim_len),
            dp(self._cc), ip64(self._cc_off),
            dp(self._hp), ip64(self._hp_off), self._n_obstacles,
            dp(self._start), dp(self._goal), dp(self._goal_box),
            self._theta_tol, dp(weights11),
            self._max_expansions,
            dp(out_nodes), out_prims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._max_path, ctypes.byref(n_path), ctypes.byref(cost),
            ctypes.byref(expansions),
        )
        self.n_expanded = int(expansions.value)
        if rc == -1:
            raise NoPathError("no path to goal")
        if rc == -2:
            raise NoPathError("expansion budget exceeded")
        if rc != 0:
            raise RuntimeError(f"native search error {rc}")

        n = int(n_path.value)
        path = [tuple(out_nodes[i]) for i in range(n)]
        trajectory = self._path_to_trajectory(out_nodes[:n], out_prims[:n])
        return float(cost.value), path, trajectory

    def _path_to_trajectory(self, nodes: np.ndarray, prims: np.ndarray) -> np.ndarray:
        chunks = []
        for i in range(1, len(nodes)):
            p = int(prims[i])  # primitive INTO node i, placed at node i-1
            pts = self._table.points[p][:-1]
            x0, y0, th0 = nodes[i - 1]
            c, s = math.cos(th0), math.sin(th0)
            chunks.append(
                np.stack(
                    [
                        x0 + c * pts[:, 0] - s * pts[:, 1],
                        y0 + s * pts[:, 0] + c * pts[:, 1],
                        pts[:, 2] + th0,
                    ],
                    axis=1,
                )
            )
        return np.concatenate(chunks, axis=0)
