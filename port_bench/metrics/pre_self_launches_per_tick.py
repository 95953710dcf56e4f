"""Pre stage besides the scan: kernels a tick launched in the span
``tick.pre`` outside ``pre.scan``: the goal test, the localization
advance, the reachability resample and the cutoff."""

from port_bench import spans


def read(ctx):
    return spans.launches_per_tick(ctx, "tick.pre")
