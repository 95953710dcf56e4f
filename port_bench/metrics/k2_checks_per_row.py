"""K2, the QP solve: the ADMM's check blocks (``admm_check_iters``
iterations and their residuals each) a solved row ran in the traced
ticks: the program's counter ``k2.checks`` over the rows its solves took."""

from port_bench import spans


def read(ctx):
    checks = spans.counter("k2.checks")
    return None if checks is None else checks / spans.solved_rows(ctx)
