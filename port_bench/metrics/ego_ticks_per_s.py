"""End to end: ego rows advanced one control tick, over all ticks the
window completed, per second of the window on the host clock (it opens
and closes at a synchronization)."""


def read(ctx):
    w = ctx["window"]
    return ctx["fleet"].rows * w["ticks"] / w["window_s"]
