"""Conflict scan: kernels a tick launched in the span ``pre.scan``:
``agents/collision.py::check_collision_moving_cars``, all its slices of
rows."""

from port_bench import spans


def read(ctx):
    return spans.launches_per_tick(ctx, "pre.scan")
