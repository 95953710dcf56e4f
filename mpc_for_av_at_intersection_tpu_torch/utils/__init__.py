"""Timing helpers of the profilers: ``benchtime`` (chained timing ended by a
value fetch) and ``timing`` (wall-clock records and a ``torch.profiler``
capture). Ports of the JAX package's ``utils/benchtime.py`` and
``utils/timing.py``; its plotting, checkpoint and demo modules are not
ported yet."""

from .benchtime import fetch_scalar, measure_fetch_cost, time_chained
from .timing import device_profile, measure_time, reset_timing, timed, timing_summary

__all__ = ["fetch_scalar", "measure_fetch_cost", "time_chained", "device_profile",
           "measure_time", "reset_timing", "timed", "timing_summary"]
