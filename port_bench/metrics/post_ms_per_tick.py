"""Post stage: device ms a tick of the kernels, copies and fills launched in
the span ``tick.post``: the plant step, the telemetry, the scripted
agents' step and the new state."""

from port_bench import spans


def read(ctx):
    return spans.ms_per_tick(ctx, "tick.post")
