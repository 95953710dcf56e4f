"""Controller, plain torch: kernels a tick launched in the span ``tick.mpc``
outside ``mpc.k1`` and ``mpc.k2``: the reference, the warm start, X = F x
and the carry update."""

from port_bench import spans


def read(ctx):
    return spans.launches_per_tick(ctx, "tick.mpc")
