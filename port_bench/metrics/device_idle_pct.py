"""Device: the share of the traced ticks' window in which no kernel, copy
or fill ran, in %."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
