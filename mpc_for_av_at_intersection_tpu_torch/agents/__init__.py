from .moving_obstacles import (
    AgentParams,
    AgentStates,
    POLICY_T_INTERSECTION,
    POLICY_ROUNDABOUT,
    POLICY_ARTERIAL,
    agents_step,
    agents_get,
    make_t_intersection_agent,
    make_roundabout_agent,
    make_arterial_agent,
    stack_agents,
)
from .prediction import predict_constant_control
from .collision import (
    check_collision_moving_cars,
    cutoff_index_by_position,
)

__all__ = [
    "AgentParams",
    "AgentStates",
    "POLICY_T_INTERSECTION",
    "POLICY_ROUNDABOUT",
    "POLICY_ARTERIAL",
    "agents_step",
    "agents_get",
    "make_t_intersection_agent",
    "make_roundabout_agent",
    "make_arterial_agent",
    "stack_agents",
    "predict_constant_control",
    "check_collision_moving_cars",
    "cutoff_index_by_position",
]
