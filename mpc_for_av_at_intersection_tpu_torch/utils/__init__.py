"""Host-side utilities, ports of the JAX package's ``utils/``: ``plotting``
(offline figures and the live view), ``checkpoint`` (snapshots and chunked
resume), ``grid_astar_demo`` (the grid-A* teaching toy), ``benchtime``
(chained timing ended by a value fetch) and ``timing`` (wall-clock records
and a ``torch.profiler`` capture)."""

from .benchtime import fetch_scalar, measure_fetch_cost, time_chained
from .plotting import (
    animate_episode,
    draw_car,
    draw_point_arrow,
    draw_scenario,
    draw_search_points,
    overlay_telemetry,
    plot_telemetry,
    plot_trajectories,
)
from .timing import device_profile, measure_time, reset_timing, timed, timing_summary

__all__ = [
    "draw_scenario",
    "draw_car",
    "draw_point_arrow",
    "draw_search_points",
    "overlay_telemetry",
    "plot_telemetry",
    "plot_trajectories",
    "animate_episode",
    "fetch_scalar",
    "measure_fetch_cost",
    "time_chained",
    "device_profile",
    "measure_time",
    "reset_timing",
    "timed",
    "timing_summary",
]
