from .closed_loop import (
    EngineConfig,
    EngineState,
    Telemetry,
    WorldArrays,
    ego_subtick_post,
    ego_subtick_pre,
    engine_state_from_numpy,
    engine_state_to_numpy,
    init_engine_state,
    make_world,
    world_from_numpy,
    world_to_numpy,
)
from .fleet import engine_tick_fleet, run_fleet_episodes

__all__ = [
    "EngineConfig",
    "EngineState",
    "Telemetry",
    "WorldArrays",
    "ego_subtick_post",
    "ego_subtick_pre",
    "engine_state_from_numpy",
    "engine_state_to_numpy",
    "init_engine_state",
    "make_world",
    "world_from_numpy",
    "world_to_numpy",
    "engine_tick_fleet",
    "run_fleet_episodes",
]
