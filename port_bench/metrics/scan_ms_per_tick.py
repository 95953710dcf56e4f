"""Conflict scan: device ms a tick of the kernels, copies and fills launched
in the span ``pre.scan``:
``agents/collision.py::check_collision_moving_cars``, all its slices of
rows."""

from port_bench import spans


def read(ctx):
    return spans.ms_per_tick(ctx, "pre.scan")
