from .obstacles import BoxObstacle, CircleObstacle, Obstacle
from .scenario import Scenario, ScenarioArrays, compile_scenario
from .envs import (
    arterial_multi_lanes,
    free_area,
    intersection,
    intersection_multi_lanes,
    roundabout,
    roundabout_big,
    t_intersection,
)

__all__ = [
    "Obstacle",
    "BoxObstacle",
    "CircleObstacle",
    "Scenario",
    "ScenarioArrays",
    "compile_scenario",
    "intersection",
    "t_intersection",
    "roundabout",
    "roundabout_big",
    "intersection_multi_lanes",
    "arterial_multi_lanes",
    "free_area",
]
