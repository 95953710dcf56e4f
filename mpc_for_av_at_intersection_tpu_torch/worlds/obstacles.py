"""World geometry: convex obstacles as unions of half-planes.

A copy of ``mpc_for_av_at_intersection_tpu/worlds/obstacles.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

Half-plane convention (parity with reference ``main/lib/obstacles.py:27-35``):
each obstacle is rows ``[a, b, c]``; a point (x, y) is *inside* the obstacle
iff ``a*x + b*y + c <= 0`` for EVERY row. Circles are approximated by a
regular octagon (reference ``obstacles.py:134-148``).

"Hidden" obstacles encode traffic-rule-forbidden lanes: they constrain the
global planner like any other obstacle but are not rendered as physical
geometry.

These classes are host-side scenario *description*; ``scenario.py`` compiles
them into fixed-size padded device arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class Obstacle:
    hidden: bool = False

    def halfplanes(self, margin: float = 0.0) -> np.ndarray:  # (H, 3)
        raise NotImplementedError

    def distance_to_point(self, point) -> float:
        raise NotImplementedError

    def contains(self, point) -> bool:
        hp = self.halfplanes()
        x, y = point[0], point[1]
        return bool(np.all(hp[:, 0] * x + hp[:, 1] * y + hp[:, 2] <= 0.0))


@dataclasses.dataclass(frozen=True)
class BoxObstacle(Obstacle):
    """Axis-aligned box given by center and (width_x, width_y)."""

    center: Tuple[float, float] = (0.0, 0.0)
    size: Tuple[float, float] = (1.0, 1.0)

    @property
    def corners(self) -> Tuple[float, float, float, float]:
        """(x1, y1, x2, y2) lower-left / upper-right."""
        cx, cy = self.center
        wx, wy = self.size
        return (cx - wx / 2.0, cy - wy / 2.0, cx + wx / 2.0, cy + wy / 2.0)

    def halfplanes(self, margin: float = 0.0) -> np.ndarray:
        x1, y1, x2, y2 = self.corners
        return np.array(
            [
                [1.0, 0.0, -(x2 + margin)],
                [-1.0, 0.0, x1 - margin],
                [0.0, 1.0, -(y2 + margin)],
                [0.0, -1.0, y1 - margin],
            ]
        )

    def distance_to_point(self, point) -> float:
        x1, y1, x2, y2 = self.corners
        dx = max(x1 - point[0], 0.0, point[0] - x2)
        dy = max(y1 - point[1], 0.0, point[1] - y2)
        return math.hypot(dx, dy)


@dataclasses.dataclass(frozen=True)
class CircleObstacle(Obstacle):
    center: Tuple[float, float] = (0.0, 0.0)
    radius: float = 1.0

    def halfplanes(self, margin: float = 0.0) -> np.ndarray:
        # circumscribing octagon, same orientation as the reference
        cx, cy = self.center
        r = self.radius
        d = r * _SQRT2 + 2.0 * margin
        return np.array(
            [
                [1.0, 0.0, -(cx + r + margin)],
                [-1.0, 0.0, cx - r - margin],
                [0.0, 1.0, -(cy + r + margin)],
                [0.0, -1.0, cy - r - margin],
                [-1.0, 1.0, cx - cy - d],
                [1.0, -1.0, -cx + cy - d],
                [-1.0, -1.0, cx + cy - d],
                [1.0, 1.0, -cx - cy - d],
            ]
        )

    def distance_to_point(self, point) -> float:
        cx, cy = self.center
        return max(0.0, math.hypot(cx - point[0], cy - point[1]) - self.radius)


def check_collision(halfplanes: np.ndarray, points_xy: np.ndarray) -> bool:
    """True iff ANY point lies inside the convex region (NumPy host helper;
    the device path lives in lattice/ as a batched einsum)."""
    vals = points_xy @ halfplanes[:, :2].T + halfplanes[:, 2]
    return bool(np.any(np.all(vals <= 0.0, axis=1)))
