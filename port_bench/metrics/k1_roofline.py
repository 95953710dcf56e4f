"""K1, the QP build: the least time of its bytes and operations at the
tick's shapes (``roofline.k1_counts``) over its device time a tick, in %."""

from port_bench.roofline import bound_ms, k1_counts

K1 = ("build_qp_kernel",)


def read(ctx):
    ms = ctx["trace"].ms_per_tick(names=K1)
    if ms <= 0:
        return None
    least, _ = bound_ms(*k1_counts(ctx["fleet"].rows, ctx["config"]["mpc"]["T"]))
    return 100.0 * least / ms
