"""K2, the QP solve: the least time of the work its rows counted over its
device time a tick, in %. The bytes are ``roofline.k2_counts``'; the
operations (``counted_ops``) are Ruiz and G'G once a row, each
factorization the program counted (``k2.factorizations``), each check
block (``k2.checks``) with its residuals, and the polish's first attempt
once a row."""

from port_bench import spans
from port_bench.roofline import bound_ms, k2_counts

K2 = ("solve_polish_kernel", "solve_polish_cluster_kernel")


def counted_ops(rows, n, m, check_iters, ruiz_iters, factorizations, checks) -> float:
    """Operations of ``rows`` solves that ran ``factorizations`` and
    ``checks`` in all (``csrc/admm.cu``, counted as ``roofline.k2_counts``
    counts the least): Ruiz's passes, G'G (its lower half), the polish's
    first attempt (P's Cholesky, the objective and Gx, two KKT solves on
    an empty active set) a row; a factorization assembles M's lower half
    and takes its Cholesky, L^-1 and L^-T L^-1 (n^3 / 3 each); a check
    block runs ``check_iters`` iterations and the residuals."""
    row = (3 * ruiz_iters * (n * n + m * n) + m * n * n
           + n ** 3 / 3 + 2 * n * n + 2 * m * n + 2 * (4 * n * n + 4 * m * n))
    factorize = n * n + n ** 3
    block = check_iters * (2 * n * n + 4 * m * n + 10 * m) + 2 * n * n + 4 * m * n
    return rows * row + factorizations * factorize + checks * block


def read(ctx):
    tr = ctx["trace"]
    ms = tr.ms_per_tick(names=K2)
    facts, checks = spans.counter("k2.factorizations"), spans.counter("k2.checks")
    if ms <= 0 or facts is None or checks is None:
        return None
    mpc = ctx["config"]["mpc"]
    n, m = 2 * mpc["T"], 4 * mpc["T"] - 1
    rows = spans.solved_rows(ctx)
    nbytes, _ = k2_counts(rows, n, m, mpc["admm_check_iters"], mpc["admm_ruiz_iters"])
    ops = counted_ops(rows, n, m, mpc["admm_check_iters"], mpc["admm_ruiz_iters"], facts, checks)
    least, _ = bound_ms(nbytes / tr.ticks, ops / tr.ticks)
    return 100.0 * least / ms
