"""The ADMM probes of the per-stage profile: three pieces of the solve, timed
apart from the controller's own kernels.

- ``admm_iterations`` (Probe-3) runs ``iters`` OSQP iterations given an
  explicit M^-1 (``csrc/admm.cu::admm_iterations_kernel``). Replaces
  ``mpc_for_av_at_intersection_tpu/ops/admm_pallas.py::admm_iterations_pallas``.
- ``admm_round_full`` (Probe-1) runs one whole round: M = P + sigma I +
  rho G'G, its Cholesky factor, M^-1 = Y'Y with Y = L^-1, ``iters``
  iterations and the round's residuals (``admm_all_rounds_kernel`` launched
  at one round). Replaces ``admm_round_full_pallas``.
- ``admm_all_rounds`` (Probe-2) runs ``rounds`` such rounds in one launch,
  every round refactorized, with the OSQP rho rule between rounds
  (``admm_all_rounds_kernel``). Replaces ``admm_all_rounds_pallas``.

They take the scaled QP as the JAX probes do, batch-major (B, ...), any
B >= 1, and return the JAX probes' tuples. Each wrapper launches its kernel
for CUDA tensors (float32, contiguous, a working set that fits one CTA's
shared memory: ``ops.admm.smem_bytes``; anything else raises) and runs its
plain version ``*_reference`` for CPU tensors, in the inputs' dtype.

The iteration, for rho > 0 per scenario:
    t = rho z - y;  x~ = M^-1 (sigma x - q + G't)
    x <- alpha x~ + (1 - alpha) x;  z~ = alpha G x~ + (1 - alpha) z
    z <- clip(z~ + y / rho, lo, hi);  y <- y + rho (z~ - z_new)
"""

from __future__ import annotations

import torch

from ..mpc.qp import _mtv, _mv
from . import _build
from .admm import PROBE3, PROBE12, check_smem


def _iterate(Minv, G, q, lo, hi, rho, x, z, y, iters: int, sigma: float, alpha: float):
    r = rho[:, None]
    for _ in range(iters):
        xt = _mv(Minv, sigma * x - q + _mtv(G, r * z - y))
        zt = alpha * _mv(G, xt) + (1.0 - alpha) * z
        x = alpha * xt + (1.0 - alpha) * x
        zn = torch.minimum(torch.maximum(zt + y / r, lo), hi)
        y = y + r * (zt - zn)
        z = zn
    return x, z, y


def _cholesky_clamped(M):
    """Lower Cholesky factor, column by column, with each pivot taken as
    sqrt(max(d, 1e-30)) as the TPU probes take it: an indefinite matrix
    gives a large finite factor, not an error or NaN."""
    n = M.shape[-1]
    A = M.clone()
    L = torch.zeros_like(M)
    for j in range(n):
        ljj = torch.sqrt(torch.clamp(A[:, j, j], min=1e-30))
        col = A[:, j + 1:, j] / ljj[:, None]
        L[:, j, j] = ljj
        L[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    return L


def _factor_inverse(P, GtG, rho, sigma: float):
    """M^-1 = Y'Y, Y = L^-1, L the clamped Cholesky factor of
    M = P' + sigma I + rho G'G (row i of M is column i of P, as the TPU
    probes build it; the two agree for a symmetric P)."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    M = (P.transpose(1, 2) + sigma * eye) + rho[:, None, None] * GtG
    L = _cholesky_clamped(M)
    Y = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return Y.transpose(1, 2) @ Y


def _residuals(P, G, q, x, z, y):
    """(prim, dual, (max|Gx|, max|z|, max|Px|, max|q|)) per row."""
    Gx = _mv(G, x)
    Px = _mv(P, x)
    prim = (Gx - z).abs().amax(1)
    dual = (Px + q + _mtv(G, y)).abs().amax(1)
    return prim, dual, (Gx.abs().amax(1), z.abs().amax(1), Px.abs().amax(1), q.abs().amax(1))


def admm_iterations_reference(Minv, G, q, lo, hi, rho, x, z, y, iters: int, sigma: float,
                              alpha: float):
    """Plain version of Probe-3. Returns (x, z, y)."""
    return _iterate(Minv, G, q, lo, hi, rho, x, z, y, iters, sigma, alpha)


def admm_round_full_reference(P, G, q, lo, hi, rho, x, z, y, iters: int, sigma: float,
                              alpha: float):
    """Plain version of Probe-1. Returns (x, z, y, prim, dual,
    (sGx, sz, sPx, sq)), the scales feeding the OSQP rho rule."""
    Minv = _factor_inverse(P, G.transpose(1, 2) @ G, rho, sigma)
    x, z, y = _iterate(Minv, G, q, lo, hi, rho, x, z, y, iters, sigma, alpha)
    prim, dual, scales = _residuals(P, G, q, x, z, y)
    return x, z, y, prim, dual, scales


def admm_all_rounds_reference(P, G, q, lo, hi, rho, x, z, y, rounds: int, iters: int,
                              sigma: float, alpha: float):
    """Plain version of Probe-2: ``rounds`` rounds, each refactorized at its
    rho, the OSQP rule rho <- clip(rho sqrt((prim_rel + 1e-12) /
    (dual_rel + 1e-12)), 1e-6, 1e6) after each. Returns (x, z, y, prim,
    dual) of the last round (zeros when ``rounds`` is 0)."""
    GtG = G.transpose(1, 2) @ G
    prim = dual = torch.zeros_like(rho)
    for _ in range(rounds):
        Minv = _factor_inverse(P, GtG, rho, sigma)
        x, z, y = _iterate(Minv, G, q, lo, hi, rho, x, z, y, iters, sigma, alpha)
        prim, dual, (sGx, sz, sPx, sq) = _residuals(P, G, q, x, z, y)
        prim_rel = prim / torch.clamp(torch.maximum(sGx, sz), min=1e-6)
        dual_rel = dual / torch.clamp(torch.maximum(sPx, sq), min=1e-6)
        rho = torch.clamp(rho * torch.sqrt((prim_rel + 1e-12) / (dual_rel + 1e-12)), 1e-6, 1e6)
    return x, z, y, prim, dual


def _check(tag, kernel, first, first_name, G, q, lo, hi, rho, x, z, y):
    """Check the probe inputs for a kernel. Returns (B, n, m)."""
    B, n = q.shape
    m = lo.shape[1]
    check_smem(tag, kernel, n, m)
    for name, t, shape in ((first_name, first, (B, n, n)), ("G", G, (B, m, n)), ("q", q, (B, n)),
                           ("lo", lo, (B, m)), ("hi", hi, (B, m)), ("rho", rho, (B,)),
                           ("x", x, (B, n)), ("z", z, (B, m)), ("y", y, (B, m))):
        _build.check_cuda(name, t, shape)
    return B, n, m


def _launch(entry, tag, inputs, B, n, m, ints, floats, outputs):
    lib = _build.load()
    dev = inputs[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*(t.data_ptr() for t in inputs), B, n, m, *ints, *floats,
                                  *(t.data_ptr() for t in outputs), _build.stream_handle(dev))
    _build.raise_on_error(tag, err)


def _empty(B, *shape, like):
    return torch.empty((B,) + shape, dtype=torch.float32, device=like.device)


def admm_iterations(Minv, G, q, lo, hi, rho, x, z, y, iters: int, sigma: float, alpha: float):
    """Probe-3: ``iters`` ADMM iterations of B scenarios with the explicit
    M^-1 ``Minv`` (B, n, n), read by rows. Returns (x, z, y)."""
    if q.device.type == "cpu":
        return admm_iterations_reference(Minv, G, q, lo, hi, rho, x, z, y, iters, sigma, alpha)
    B, n, m = _check("Probe-3 admm_iterations", PROBE3, Minv, "Minv", G, q, lo, hi, rho, x, z, y)
    out = (_empty(B, n, like=q), _empty(B, m, like=q), _empty(B, m, like=q))
    _launch("admm_iterations", "Probe-3 admm_iterations", (Minv, G, q, lo, hi, rho, x, z, y),
            B, n, m, (iters,), (sigma, alpha), out)
    admm_iterations.launches += 1
    return out


def admm_round_full(P, G, q, lo, hi, rho, x, z, y, iters: int, sigma: float, alpha: float):
    """Probe-1: one full ADMM round (factorization, ``iters`` iterations,
    residuals). Returns (x, z, y, prim, dual, (sGx, sz, sPx, sq))."""
    if q.device.type == "cpu":
        return admm_round_full_reference(P, G, q, lo, hi, rho, x, z, y, iters, sigma, alpha)
    B, n, m = _check("Probe-1 admm_round_full", PROBE12, P, "P", G, q, lo, hi, rho, x, z, y)
    xo, zo, yo = _empty(B, n, like=q), _empty(B, m, like=q), _empty(B, m, like=q)
    res = _empty(B, 6, like=q)
    _launch("admm_round_full", "Probe-1 admm_round_full", (P, G, q, lo, hi, rho, x, z, y),
            B, n, m, (iters,), (sigma, alpha), (xo, zo, yo, res))
    admm_round_full.launches += 1
    r = res.unbind(1)
    return xo, zo, yo, r[0], r[1], r[2:]


def admm_all_rounds(P, G, q, lo, hi, rho, x, z, y, rounds: int, iters: int, sigma: float,
                    alpha: float):
    """Probe-2: ``rounds`` full rounds with the rho rule in between, one
    launch. Returns (x, z, y, prim, dual) of the last round."""
    if q.device.type == "cpu":
        return admm_all_rounds_reference(P, G, q, lo, hi, rho, x, z, y, rounds, iters, sigma,
                                         alpha)
    B, n, m = _check("Probe-2 admm_all_rounds", PROBE12, P, "P", G, q, lo, hi, rho, x, z, y)
    xo, zo, yo = _empty(B, n, like=q), _empty(B, m, like=q), _empty(B, m, like=q)
    res = _empty(B, 6, like=q)
    _launch("admm_all_rounds", "Probe-2 admm_all_rounds", (P, G, q, lo, hi, rho, x, z, y),
            B, n, m, (rounds, iters), (sigma, alpha), (xo, zo, yo, res))
    admm_all_rounds.launches += 1
    return xo, zo, yo, res[:, 0], res[:, 1]


admm_iterations.launches = 0
admm_round_full.launches = 0
admm_all_rounds.launches = 0
