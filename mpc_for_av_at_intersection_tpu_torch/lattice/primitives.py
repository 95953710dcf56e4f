"""Motion-primitive table generation (replaces the reference's pickles).

A copy of ``mpc_for_av_at_intersection_tpu/lattice/primitives.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

The reference pre-generates 9 short constant-control arcs per vehicle model
and pickles them (``main/create_motion_primitives_bicycle_model.py``,
``main/lib/motion_primitive.py``). We generate the same table on the fly as
one dense array — 9 forward-Euler rollouts of the kinematic bicycle.

Parity note: the committed bicycle pickles were generated with dt=0.01 for
60 steps at 8.3 m/s (verified by direct inspection of the pickles; the
generator script's stated dt constant is stale). The defaults below
reproduce those pickles to float precision. The reference's Prius pickles
came from a PyBullet episode (urdfenvs, not available here); for the Prius
we roll the same kinematic model with the Prius wheelbase — a documented
divergence that preserves the capability.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..models import VehicleGeometry

# (name, steering angle) — create_motion_primitives_prius.py:19-29
PRIMITIVE_SPECS: Tuple[Tuple[str, float], ...] = (
    ("straight", 0.0),
    ("left1", 0.1),
    ("left2", 0.2),
    ("left3", 0.3),
    ("left4", 0.4),
    ("right1", -0.1),
    ("right2", -0.2),
    ("right3", -0.3),
    ("right4", -0.4),
)


class PrimitiveTable(NamedTuple):
    names: Tuple[str, ...]
    steers: np.ndarray    # (P,)
    points: np.ndarray    # (P, K, 3) poses starting at the origin
    lengths: np.ndarray   # (P,) total arc length

    @property
    def n_primitives(self) -> int:
        return self.points.shape[0]


def primitive_table(
    geom: VehicleGeometry,
    forward_speed: float = 8.3,
    dt: float = 0.01,
    n_steps: int = 60,
    dtype=np.float64,
) -> PrimitiveTable:
    P = len(PRIMITIVE_SPECS)
    K = n_steps + 1
    steers = np.array([s for _, s in PRIMITIVE_SPECS], dtype)
    pts = np.zeros((P, K, 3), dtype)
    x = np.zeros(P, dtype)
    y = np.zeros(P, dtype)
    th = np.zeros(P, dtype)
    for k in range(1, K):
        x = x + forward_speed * np.cos(th) * dt
        y = y + forward_speed * np.sin(th) * dt
        th = th + (forward_speed / geom.wheelbase) * np.tan(steers) * dt
        pts[:, k, 0] = x
        pts[:, k, 1] = y
        pts[:, k, 2] = th
    lengths = np.linalg.norm(np.diff(pts[:, :, :2], axis=1), axis=2).sum(axis=1)
    return PrimitiveTable(
        names=tuple(n for n, _ in PRIMITIVE_SPECS),
        steers=steers,
        points=pts,
        lengths=lengths,
    )
