"""K2, the QP solve: its device ms a tick, on one CTA or on a cluster."""

K2 = ("solve_polish_kernel", "solve_polish_cluster_kernel")


def read(ctx):
    ms = ctx["trace"].ms_per_tick(names=K2)
    return ms if ms > 0 else None
