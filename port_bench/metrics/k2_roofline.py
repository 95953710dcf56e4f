"""K2, the QP solve: the least time of its bytes and of the least
operations any solve at the tick's shapes runs (``roofline.k2_counts``)
over its device time a tick, in %."""

from port_bench.roofline import bound_ms, k2_counts

K2 = ("solve_polish_kernel", "solve_polish_cluster_kernel")


def read(ctx):
    ms = ctx["trace"].ms_per_tick(names=K2)
    if ms <= 0:
        return None
    mpc = ctx["config"]["mpc"]
    n, m = 2 * mpc["T"], 4 * mpc["T"] - 1
    least, _ = bound_ms(*k2_counts(ctx["fleet"].rows, n, m, mpc["admm_check_iters"],
                                   mpc["admm_ruiz_iters"]))
    return 100.0 * least / ms
