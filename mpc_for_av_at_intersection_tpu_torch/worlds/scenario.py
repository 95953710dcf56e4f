"""Scenario description + compiler to fixed-size padded device arrays.

A copy of ``mpc_for_av_at_intersection_tpu/worlds/scenario.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

``Scenario`` is the host-side analogue of reference ``main/lib/scenario.py``;
``compile_scenario`` turns the obstacle list into the `(O, H, 3)` half-plane
tensor + validity masks that the batched device planner consumes. Padding
rules:

- unused half-plane rows of a real obstacle are `[0, 0, -1]` (always
  satisfied, so they never break the "inside = all rows <= 0" conjunction);
- entirely padded obstacle slots are a single `[0, 0, +1]` row (never
  satisfied, so the slot can never report a collision).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .obstacles import BoxObstacle, Obstacle


@dataclasses.dataclass(frozen=True)
class Scenario:
    start: Tuple[float, float, float]
    goal_point: Tuple[float, float, float]
    goal_area: BoxObstacle
    allowed_goal_theta_difference: float
    obstacles: List[Obstacle]


@dataclasses.dataclass(frozen=True)
class ScenarioArrays:
    """Padded array form of one scenario (all NumPy; move to device as
    needed). Batch scenarios by stacking along a new leading axis."""

    start: np.ndarray            # (3,)
    goal_point: np.ndarray       # (3,)
    goal_area_corners: np.ndarray  # (4,) x1,y1,x2,y2
    goal_theta_tol: float
    halfplanes: np.ndarray       # (O, H, 3)
    hp_valid: np.ndarray         # (O, H) bool
    obstacle_valid: np.ndarray   # (O,) bool


def compile_scenario(
    scenario: Scenario,
    margin: float = 0.0,
    max_obstacles: int = 32,
    max_halfplanes: int = 8,
) -> ScenarioArrays:
    obs = scenario.obstacles
    if len(obs) > max_obstacles:
        raise ValueError(
            f"scenario has {len(obs)} obstacles > max_obstacles={max_obstacles}"
        )

    O, H = max_obstacles, max_halfplanes
    hp = np.zeros((O, H, 3), dtype=np.float64)
    hp[:, :, 2] = 1.0  # default: impossible region (1 <= 0 is false)
    hp_valid = np.zeros((O, H), dtype=bool)
    obstacle_valid = np.zeros((O,), dtype=bool)

    for i, o in enumerate(obs):
        rows = o.halfplanes(margin=margin)
        if rows.shape[0] > H:
            raise ValueError(f"obstacle {i} has {rows.shape[0]} > {H} half-planes")
        hp[i, : rows.shape[0]] = rows
        hp[i, rows.shape[0]:] = np.array([0.0, 0.0, -1.0])  # always satisfied
        hp_valid[i, : rows.shape[0]] = True
        obstacle_valid[i] = True

    return ScenarioArrays(
        start=np.asarray(scenario.start, dtype=np.float64),
        goal_point=np.asarray(scenario.goal_point, dtype=np.float64),
        goal_area_corners=np.asarray(scenario.goal_area.corners, dtype=np.float64),
        goal_theta_tol=float(scenario.allowed_goal_theta_difference),
        halfplanes=hp,
        hp_valid=hp_valid,
        obstacle_valid=obstacle_valid,
    )


def stack_scenario_arrays(items: Sequence[ScenarioArrays]) -> ScenarioArrays:
    """Stack compiled scenarios along a leading batch axis."""
    return ScenarioArrays(
        start=np.stack([s.start for s in items]),
        goal_point=np.stack([s.goal_point for s in items]),
        goal_area_corners=np.stack([s.goal_area_corners for s in items]),
        goal_theta_tol=np.asarray([s.goal_theta_tol for s in items]),
        halfplanes=np.stack([s.halfplanes for s in items]),
        hp_valid=np.stack([s.hp_valid for s in items]),
        obstacle_valid=np.stack([s.obstacle_valid for s in items]),
    )
