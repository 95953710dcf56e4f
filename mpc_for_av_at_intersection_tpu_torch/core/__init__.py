from .angles import normalize_angle, smooth_yaw, smooth_yaw_numpy
from .curves import nearest_index, nearest_index_in_direction
from .dynamics import SimLimits, plant_rollout, plant_step

__all__ = [
    "normalize_angle",
    "smooth_yaw",
    "smooth_yaw_numpy",
    "nearest_index",
    "nearest_index_in_direction",
    "SimLimits",
    "plant_rollout",
    "plant_step",
]
