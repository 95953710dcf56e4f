"""Parametric junction generators.

A copy of ``mpc_for_av_at_intersection_tpu/worlds/envs.py`` (numpy only), so
that the port loads nothing of the JAX package;
``tests/test_torch_worlds_lattice.py`` pins it to the original.

Capability parity with reference ``main/envs/*.py``: each factory returns a
``Scenario`` whose obstacle set (including *hidden* traffic-rule planes)
matches the reference geometry. Conventions shared by all cross-shaped
junctions:

- start_pos: 1=south, 2=west, 3=north, 4=east
- turn_indicator: 1=left, 2=straight, 3=right, 4=U-turn (roundabouts only)

The reference repeats ~300 lines per env; here the shared cross geometry is
factored into private helpers, parameterized by lane/island/pavement widths.
Reference quirks that affect planner behavior are reproduced and marked with
"quirk:" comments.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .obstacles import BoxObstacle, CircleObstacle, Obstacle
from .scenario import Scenario

_PI = math.pi
ARM_LENGTH = 30.0
PAVEMENT = 5.0
CORNER_RADIUS = 6.0
GOAL_THETA_TOL = _PI / 16.0


def _cross_goal_tables(lane_offset: float, goal_offset: float, dist: float):
    """Start/goal pose tables for a 4-arm junction.

    lane_offset: lateral offset of the start lane center from the road axis.
    goal_offset: lateral offset of the goal lane center.
    """
    starts = {
        1: (lane_offset, -dist, 0.5 * _PI),
        2: (-dist, -lane_offset, 0.0),
        3: (-lane_offset, dist, -0.5 * _PI),
        4: (dist, lane_offset, _PI),
    }
    g = goal_offset
    # arrival poses per compass exit arm
    west = (-dist, g, -_PI)
    north = (g, dist, 0.5 * _PI)
    east = (dist, -g, 0.0)
    south = (-g, -dist, -0.5 * _PI)
    goals = {
        1: {1: west, 2: north, 3: east, 4: south},
        2: {1: north, 2: east, 3: south, 4: west},
        3: {1: east, 2: south, 3: west, 4: north},
        4: {1: south, 2: west, 3: north, 4: east},
    }
    return starts, goals


def _goal_area(
    start_pos: int, turn_indicator: int, goal_xy, along: float, across: float
) -> BoxObstacle:
    """Goal box oriented by whether the exit arm is horizontal or vertical
    (reference ``envs/intersection.py:57-61``)."""
    horizontal_exit = ((start_pos in (1, 3)) and (turn_indicator in (1, 3))) or (
        (start_pos in (2, 4)) and (turn_indicator in (2, 4))
    )
    size = (along, across) if horizontal_exit else (across, along)
    return BoxObstacle(center=(goal_xy[0], goal_xy[1]), size=size)


def _median(arm: str, island: float, dc: float) -> List[Obstacle]:
    """Median strip + rounded endcap for one arm (south/west/north/east)."""
    L = ARM_LENGTH
    if arm == "south":
        return [
            BoxObstacle(center=(0.0, -(L / 2 + dc)), size=(island, L)),
            CircleObstacle(center=(0.0, -dc), radius=island / 2),
        ]
    if arm == "north":
        return [
            BoxObstacle(center=(0.0, (L / 2 + dc)), size=(island, L)),
            CircleObstacle(center=(0.0, dc), radius=island / 2),
        ]
    if arm == "west":
        return [
            BoxObstacle(center=(-(L / 2 + dc), 0.0), size=(L, island)),
            CircleObstacle(center=(-dc, 0.0), radius=island / 2),
        ]
    return [
        BoxObstacle(center=((L / 2 + dc), 0.0), size=(L, island)),
        CircleObstacle(center=(dc, 0.0), radius=island / 2),
    ]


def _corner(xsign: int, ysign: int, radius: float, dc: float) -> CircleObstacle:
    return CircleObstacle(center=(xsign * dc, ysign * dc), radius=radius)


def _pavement_pair(arm: str, road_half: float, dc: float) -> List[Obstacle]:
    """The two sidewalk blocks flanking one arm."""
    L = ARM_LENGTH
    off = road_half + PAVEMENT / 2
    far = L / 2 + dc
    if arm in ("south", "north"):
        y = -far if arm == "south" else far
        return [
            BoxObstacle(center=(-off, y), size=(PAVEMENT, L)),
            BoxObstacle(center=(off, y), size=(PAVEMENT, L)),
        ]
    x = -far if arm == "west" else far
    return [
        BoxObstacle(center=(x, -off), size=(L, PAVEMENT)),
        BoxObstacle(center=(x, off), size=(L, PAVEMENT)),
    ]


def _hidden_lane(arm: str, lat_sign: int, lane_block: float, median: float, dc: float) -> BoxObstacle:
    """A hidden wrong-way lane block on one arm. ``lat_sign`` picks which
    side of the median; ``lane_block`` is the blocked width."""
    L = ARM_LENGTH
    off = lat_sign * (lane_block + median) / 2
    far = L / 2 + dc
    if arm == "west":
        return BoxObstacle(center=(-far, off), size=(L, lane_block), hidden=True)
    if arm == "east":
        return BoxObstacle(center=(far, off), size=(L, lane_block), hidden=True)
    if arm == "south":
        return BoxObstacle(center=(off, -far), size=(lane_block, L), hidden=True)
    return BoxObstacle(center=(off, far), size=(lane_block, L), hidden=True)


# Hidden wrong-way lane sign tables per start position: for each of
# (west, east, south, north) arms, which lateral side is forbidden.
# Transcribed from reference envs/intersection.py:149-208.
_HIDDEN_SIGNS: Dict[int, Dict[str, int]] = {
    1: {"west": -1, "east": +1, "south": -1, "north": -1},
    2: {"west": +1, "east": +1, "south": +1, "north": -1},
    3: {"west": -1, "east": +1, "south": +1, "north": +1},
    4: {"west": -1, "east": -1, "south": +1, "north": -1},
}


def intersection(turn_indicator: int, start_pos: int, road: float = 4.0,
                 island: float = 2.0,
                 corner_radius: float = CORNER_RADIUS) -> Scenario:
    """Single-lane unsignalized 4-way intersection
    (reference ``main/envs/intersection.py:10-216``).

    ``road`` (lane width), ``island`` (median width), and
    ``corner_radius`` are the junction's geometric parameters (reference
    intersection.py:11-17 hard-codes 4.0 / 2.0 / 6.0 — the defaults
    here); varying them yields a sampled-geometry family for Monte-Carlo
    studies (``api.sample_intersection_fleet_geom``)."""
    dc = corner_radius + road + island
    lane_c = island / 2 + road / 2
    goal_c = (island + road) / 2
    starts, goals = _cross_goal_tables(lane_c, goal_c, 30.0)
    start = starts[start_pos]
    goal = goals[start_pos][turn_indicator]
    goal_area = _goal_area(start_pos, turn_indicator, goal, road * 1.8, road)

    corner_r = dc - island / 2 - road
    obstacles: List[Obstacle] = []
    for arm in ("south", "north", "west", "east"):
        obstacles += _median(arm, island, dc)
    for xs, ys in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
        obstacles.append(_corner(xs, ys, corner_r, dc))
    for arm in ("south", "west", "north", "east"):
        obstacles += _pavement_pair(arm, island / 2 + road, dc)
    for arm in ("west", "east", "south", "north"):
        obstacles.append(_hidden_lane(arm, _HIDDEN_SIGNS[start_pos][arm], road, island, dc))

    return Scenario(start, goal, goal_area, GOAL_THETA_TOL, obstacles)


# T-intersection hidden-lane tables (reference envs/t_intersection.py:118-153;
# note there is no north arm, and start_pos 3 is invalid).
_T_HIDDEN: Dict[int, List[Tuple[str, int]]] = {
    1: [("west", -1), ("east", +1), ("south", -1)],
    2: [("west", +1), ("east", +1), ("south", +1)],
    4: [("west", -1), ("east", -1), ("south", +1)],
}


def t_intersection(turn_indicator: int, start_pos: int) -> Scenario:
    """3-arm T-intersection (reference ``main/envs/t_intersection.py:10-161``).
    Valid starts: 1 (south), 2 (west), 4 (east)."""
    road, island = 4.0, 2.0
    dc = CORNER_RADIUS + road + island
    lane_c = island / 2 + road / 2
    goal_c = (island + road) / 2
    starts, goals = _cross_goal_tables(lane_c, goal_c, 30.0)
    if start_pos not in (1, 2, 4):
        raise ValueError("t_intersection start_pos must be 1, 2, or 4")
    valid_turns = {1: (1, 3), 2: (2, 3), 4: (1, 2)}[start_pos]
    if turn_indicator not in valid_turns:
        raise ValueError(f"turn {turn_indicator} invalid from start {start_pos}")
    start = starts[start_pos]
    goal = goals[start_pos][turn_indicator]
    goal_area = _goal_area(start_pos, turn_indicator, goal, road * 1.8, road)

    corner_r = dc - island / 2 - road
    obstacles: List[Obstacle] = []
    for arm in ("south", "west", "east"):
        obstacles += _median(arm, island, dc)
    obstacles += [_corner(-1, -1, corner_r, dc), _corner(1, -1, corner_r, dc)]
    obstacles += _pavement_pair("south", island / 2 + road, dc)
    # west/east arms only have the lower (south-side) sidewalk
    off = island / 2 + road + PAVEMENT / 2
    far = ARM_LENGTH / 2 + dc
    obstacles += [
        BoxObstacle(center=(-far, -off), size=(ARM_LENGTH, PAVEMENT)),
        BoxObstacle(center=(far, -off), size=(ARM_LENGTH, PAVEMENT)),
        # the single long wall closing the top of the T
        BoxObstacle(center=(0.0, off), size=(2 * (ARM_LENGTH + dc), PAVEMENT)),
    ]
    for arm, sign in _T_HIDDEN[start_pos]:
        obstacles.append(_hidden_lane(arm, sign, road, island, dc))

    return Scenario(start, goal, goal_area, GOAL_THETA_TOL, obstacles)


# Roundabout rule-box placement per start (reference envs/roundabout.py):
# blocks cutting across the central island on the approach side.
def _roundabout_rule_box(start_pos: int, island: float, dc: float) -> BoxObstacle:
    if start_pos == 1:
        return BoxObstacle(center=(0.0, -dc / 2), size=(island / 2, dc), hidden=True)
    if start_pos == 2:
        return BoxObstacle(center=(-dc / 2, 0.0), size=(dc, island / 2), hidden=True)
    if start_pos == 3:
        return BoxObstacle(center=(0.0, dc / 2), size=(island / 2, dc), hidden=True)
    return BoxObstacle(center=(dc / 2, 0.0), size=(dc, island / 2), hidden=True)


# Hidden-lane sign tables for roundabouts (reference envs/roundabout.py:
# start 1 omits the south block — the ego's own approach arm stays fully open).
_RB_HIDDEN: Dict[int, List[Tuple[str, int]]] = {
    1: [("west", -1), ("east", +1), ("north", -1)],
    2: [("west", +1), ("east", +1), ("south", +1), ("north", -1)],
    3: [("west", -1), ("east", +1), ("south", +1), ("north", +1)],
    4: [("west", -1), ("east", -1), ("south", +1), ("north", -1)],
}


def _roundabout_impl(
    turn_indicator: int, start_pos: int, road: float, island: float, center_r: float
) -> Scenario:
    dc = CORNER_RADIUS + road + island / 2
    lane_c = island / 2 + road / 2
    goal_c = (island + road) / 2
    starts, goals = _cross_goal_tables(lane_c, goal_c, 30.0)
    start = starts[start_pos]
    goal = goals[start_pos][turn_indicator]
    goal_area = _goal_area(start_pos, turn_indicator, goal, road * 1.8, road)

    corner_r = dc - island / 2 - road
    obstacles: List[Obstacle] = [CircleObstacle(center=(0.0, 0.0), radius=center_r)]
    for arm in ("south", "north", "west", "east"):
        obstacles += _median(arm, island, dc)
    for xs, ys in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
        obstacles.append(_corner(xs, ys, corner_r, dc))
    for arm in ("south", "west", "north", "east"):
        obstacles += _pavement_pair(arm, island / 2 + road, dc)
    # hidden outer walls bounding the searchable area
    obstacles += [
        BoxObstacle(center=(40.0, 0.0), size=(1.0, 100.0), hidden=True),
        BoxObstacle(center=(-40.0, 0.0), size=(1.0, 100.0), hidden=True),
        BoxObstacle(center=(0.0, 40.0), size=(100.0, 1.0), hidden=True),
        BoxObstacle(center=(0.0, -40.0), size=(100.0, 1.0), hidden=True),
    ]
    for arm, sign in _RB_HIDDEN[start_pos]:
        obstacles.append(_hidden_lane(arm, sign, road, island, dc))
    obstacles.append(_roundabout_rule_box(start_pos, island, dc))

    return Scenario(start, goal, goal_area, GOAL_THETA_TOL, obstacles)


def roundabout(turn_indicator: int, start_pos: int) -> Scenario:
    """Standard roundabout incl. U-turns (reference ``main/envs/roundabout.py``)."""
    return _roundabout_impl(turn_indicator, start_pos, road=4.0, island=2.0, center_r=2.0)


def roundabout_big(turn_indicator: int, start_pos: int) -> Scenario:
    """Wide-geometry roundabout (reference ``main/envs/roundabout_big.py``:
    road 4.2, island 4, center radius 4)."""
    return _roundabout_impl(turn_indicator, start_pos, road=4.2, island=4.0, center_r=4.0)


def intersection_multi_lanes(
    turn_indicator: int = 1,
    start_pos: int = 1,
    start_lane: int = 1,
    goal_lane: int = 1,
    number_of_lanes: int = 1,
) -> Scenario:
    """N-lane 4-way intersection
    (reference ``main/envs/intersection_multi_lanes.py:9-221``)."""
    lane, median = 4.0, 2.0
    n = number_of_lanes
    sos = CORNER_RADIUS + lane * n + median  # start_of_section
    lane_c = median / 2 + (start_lane - 1) * lane + lane / 2
    goal_c = (median + lane) / 2 + (goal_lane - 1) * lane
    starts, goals = _cross_goal_tables(lane_c, goal_c, 30.0)
    start = starts[start_pos]
    goal = goals[start_pos][turn_indicator]
    goal_area = _goal_area(start_pos, turn_indicator, goal, lane * 1.8, 1.5)

    corner_r = sos - median / 2 - n * lane
    obstacles: List[Obstacle] = []
    for arm in ("south", "north", "west", "east"):
        obstacles += _median(arm, median, sos)
    for xs, ys in ((-1, -1), (-1, 1), (1, 1), (1, -1)):
        obstacles.append(_corner(xs, ys, corner_r, sos))
    for arm in ("south", "west", "north", "east"):
        obstacles += _pavement_pair(arm, median / 2 + n * lane, sos)

    block = n * lane
    for arm in ("west", "east", "south", "north"):
        hb = _hidden_lane(arm, _HIDDEN_SIGNS[start_pos][arm], block, median, sos)
        # quirk: reference start_pos=4 east arm uses a single-lane offset
        # (envs/intersection_multi_lanes.py "else" branch, second box)
        if start_pos == 4 and arm == "east":
            far = ARM_LENGTH / 2 + sos
            hb = BoxObstacle(
                center=(far, -(lane + median) / 2), size=(ARM_LENGTH, block), hidden=True
            )
        obstacles.append(hb)

    return Scenario(start, goal, goal_area, GOAL_THETA_TOL, obstacles)


def arterial_multi_lanes(num_lanes: int = 2, goal_lane: int = 1, length: float = 100.0) -> Scenario:
    """Straight multi-lane arterial road with a lane-change goal
    (reference ``main/envs/arterial_multi_lanes.py:11-57``)."""
    if num_lanes < 1:
        raise ValueError("num_lanes must be >= 1")
    if goal_lane > num_lanes:
        raise ValueError("goal_lane must be <= num_lanes")
    road = 4.0
    left = -(num_lanes * road / 2) - PAVEMENT / 2
    right = (num_lanes * road / 2) + PAVEMENT / 2
    lane_offset = (num_lanes // 2 - 0.5) * road - (goal_lane - 1) * road
    if num_lanes % 2 != 0:
        lane_offset += road / 2
    start = (road * (num_lanes / 2 - 0.5), -length / 2, _PI / 2)
    goal = (lane_offset, length / 2, _PI / 2)
    goal_area = BoxObstacle(center=(goal[0], goal[1]), size=(road, road))
    obstacles: List[Obstacle] = [
        BoxObstacle(center=(left, 0.0), size=(PAVEMENT, length)),
        BoxObstacle(center=(right, 0.0), size=(PAVEMENT, length)),
    ]
    return Scenario(start, goal, goal_area, GOAL_THETA_TOL, obstacles)


def free_area(
    test_no: int = 1,
    angle: float = 0.0,
    start_pos: float = 0.0,
    goal_distance: float = 20.0,
    acceptable_error: float = _PI / 16.0,
) -> Scenario:
    """Obstacle-free reachability test env (reference ``main/envs/free_area.py``,
    with its import/match bitrot fixed)."""
    start = (start_pos, start_pos, 0.0)
    gx = start_pos + goal_distance * math.cos(angle)
    gy = start_pos + goal_distance * math.sin(angle)
    goal = (gx, gy, angle if test_no == 1 else 0.0)
    goal_area = BoxObstacle(center=(gx, gy), size=(4.0 * 1.8, 4.0))
    return Scenario(start, goal, goal_area, acceptable_error, [])
