from .primitives import PrimitiveTable, primitive_table, PRIMITIVE_SPECS
from .astar import AStar, NoPathError
from .search import SearchWeights, MotionPrimitiveSearch
from .wavefront import (
    WavefrontConfig,
    WavefrontResult,
    grid_for,
    plan_courses_device,
    prepare_primitives,
    wavefront_search,
)

__all__ = [
    "PrimitiveTable",
    "primitive_table",
    "PRIMITIVE_SPECS",
    "AStar",
    "NoPathError",
    "SearchWeights",
    "MotionPrimitiveSearch",
    "WavefrontConfig",
    "WavefrontResult",
    "grid_for",
    "plan_courses_device",
    "prepare_primitives",
    "wavefront_search",
]
