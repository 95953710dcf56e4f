"""Pre stage besides the scan: device ms a tick of the kernels, copies and
fills launched in the span ``tick.pre`` outside ``pre.scan``: the goal
test, the localization advance, the reachability resample and the cutoff."""

from port_bench import spans


def read(ctx):
    return spans.ms_per_tick(ctx, "tick.pre")
