from .angles import hypot, normalize_angle, smooth_yaw, smooth_yaw_numpy
from .curves import (
    compact_by_mask,
    cumsum_blocked,
    nearest_index,
    nearest_index_in_direction,
    resample_mask,
    take_rows,
)
from .dynamics import SimLimits, plant_rollout, plant_step

__all__ = [
    "hypot",
    "normalize_angle",
    "smooth_yaw",
    "smooth_yaw_numpy",
    "compact_by_mask",
    "cumsum_blocked",
    "nearest_index",
    "nearest_index_in_direction",
    "resample_mask",
    "take_rows",
    "SimLimits",
    "plant_rollout",
    "plant_step",
]
