from .angles import hypot, normalize_angle, smooth_yaw, smooth_yaw_numpy
from .curves import (
    arc_positions,
    compact_by_mask,
    cumsum_blocked,
    nearest_index,
    nearest_index_in_direction,
    resample_mask,
    take_rows,
)
from .dynamics import SimLimits, bicycle_rollout, bicycle_step, plant_rollout, plant_step
from .transforms import transform_points_xy, transform_poses

__all__ = [
    "hypot",
    "normalize_angle",
    "smooth_yaw",
    "smooth_yaw_numpy",
    "arc_positions",
    "compact_by_mask",
    "cumsum_blocked",
    "nearest_index",
    "nearest_index_in_direction",
    "resample_mask",
    "take_rows",
    "SimLimits",
    "bicycle_rollout",
    "bicycle_step",
    "plant_rollout",
    "plant_step",
    "transform_points_xy",
    "transform_poses",
]
