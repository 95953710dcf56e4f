"""Roofline arithmetic of the controller's kernels against the published
peaks of one NVIDIA H100 SXM (dense float32 outside the tensor cores,
HBM3), as ``chip_smoke.py``'s ``_bound`` and ``k1_bound`` count them:
inputs read once, outputs written once, float32 (4 bytes).

K2's operations are the least that any solve at the shapes runs, so that
no implementation can read over 100%: Ruiz's passes, G'G, one Cholesky of
the ADMM matrix, one block of ``check_iters`` iterations and its residuals,
and the polish's first attempt, which every row makes
(``csrc/admm.cu::polish_and_select`` runs attempt 1 unconditionally): P's
Cholesky, the objective and Gx, and its two KKT solves on an empty active
set. Further checks, refactorizations, active rows and second attempts are
not counted.
"""

from __future__ import annotations

HBM_BPS = 3.35e12     # bytes/s
F32_FLOPS = 67e12     # FLOP/s


def bound_ms(nbytes: float, flops: float):
    """(least ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_counts(B: int, T: int):
    """(bytes, operations) of K1 for B rows at horizon T (n = 2T, m = 4T-1,
    nx = 4): the state, previous controls and reference in; P, q, G, lo,
    hi, F and g out. Operations: the rollout, F's column recurrences and
    the sums of P and q."""
    n, m, nx = 2 * T, 4 * T - 1, 4
    nbytes = B * (4 * (4 + 2 * T + 4 * (T + 1)) + (T + 1)
                  + 4 * (n * n + n + m * n + 2 * m + nx * T * n + nx * T))
    flops = B * (n * T * 32 + n * n // 2 * T * 20 + n * T * 20 + 200 * T)
    return nbytes, flops


def k2_counts(B: int, n: int, m: int, check_iters: int, ruiz_iters: int):
    """(bytes, least operations) of K2 for B warm-started rows: P, q, G,
    lo, hi and the warm x, y, rho in; x, y and four scalars out."""
    nbytes = B * 4 * (n * n + n + m * n + 2 * m + (n + m + 1) + n + m + 4)
    admm = (3 * ruiz_iters * (n * n + m * n) + m * n * n + n ** 3 / 3
            + check_iters * (2 * n * n + 4 * m * n + 10 * m) + 2 * n * n + 4 * m * n)
    polish = n ** 3 / 3 + 2 * n * n + 2 * m * n + 2 * (4 * n * n + 4 * m * n)
    return nbytes, B * (admm + polish)
