"""Engine loop: device kernels a tick in the traced ticks."""


def read(ctx):
    tr = ctx["trace"]
    n = len(tr.kernels())
    return n / tr.ticks if n else None
