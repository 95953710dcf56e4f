"""Engine loop: the host's median time to issue one tick of the measured
window (the tick call alone, no synchronization in it), in ms."""

import statistics


def read(ctx):
    host = ctx["window"]["host_s"]
    return statistics.median(host) * 1e3 if host else None
