"""Batched dense box-QP solver: OSQP-style adaptive ADMM + active-set polish.

Port of the batched XLA path of ``mpc_for_av_at_intersection_tpu/mpc/qp.py``
(``_solve_box_qp_batched_impl`` and ``_polish_and_select``), in two halves:
``ruiz_admm_batched`` (Ruiz + adaptive ADMM) and ``polish_and_select``
(the two-attempt polish). They are the plain versions of the solve kernels
in ``ops/admm.py``: of A/B-1 and A/B-2 each, and together of the fused K2.
The kernels must agree with them, and a call on CPU tensors runs them.
Every function here takes the batch as the leading axis and works in
float32 or float64, and returns its results in the dtype of its inputs.

Problem form: min 1/2 x'Px + q'x  s.t.  lo <= Gx <= hi.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# The controller uses a solve only if its returned x violates no constraint
# by more than this (``mpc/batch.py``).
SOLVED_PRIM_MAX = 1e-2
# A scenario may take the stall exit only while its scaled primal residual
# is below half the ``solved`` gate, so a stalled solve is still one the
# controller uses.
STALL_PRIM_CAP = 0.5 * SOLVED_PRIM_MAX
# polish: a row is taken as active where |y| exceeds this share of max|y|
ACT_TOL_REL = 1e-4


class QPSolution(NamedTuple):
    x: torch.Tensor          # (B, n) primal solution
    y: torch.Tensor          # (B, m) dual for lo <= Gx <= hi (+: upper, -: lower)
    polished: torch.Tensor   # (B,) bool, polish accepted
    prim_res: torch.Tensor   # (B,) inf-norm primal residual of the returned x
    dual_res: torch.Tensor   # (B,) inf-norm dual residual (scaled, pre-polish)
    rho: Optional[torch.Tensor] = None     # (B,) final ADMM penalty
    checks: Optional[torch.Tensor] = None  # (B,) iteration blocks executed


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _cholesky(M):
    """Lower Cholesky factor; a failed factorization yields a NaN factor for
    that row of the batch (what XLA returns) instead of raising."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)


def _ruiz_equilibrate(P, q, G, iters: int = 10):
    """Modified Ruiz equilibration of the KKT operator [[P, G'], [G, 0]]
    plus OSQP-style cost normalization. Returns (d (B, n), e (B, m), c (B,)):
    variable, constraint and cost scaling."""
    B, n = q.shape
    m = G.shape[1]
    d = torch.ones((B, n), dtype=q.dtype, device=q.device)
    e = torch.ones((B, m), dtype=q.dtype, device=q.device)
    c = torch.ones((B,), dtype=q.dtype, device=q.device)
    eps = 1e-8
    for _ in range(iters):
        Ps = (c[:, None, None] * d[:, :, None]) * P * d[:, None, :]
        Gs = e[:, :, None] * G * d[:, None, :]
        col_x = torch.maximum(Ps.abs().amax(1), Gs.abs().amax(1))
        row_y = Gs.abs().amax(2)
        d = d / torch.sqrt(torch.clamp(col_x, min=eps))
        e = e / torch.sqrt(torch.clamp(row_y, min=eps))
        # cost normalization
        Ps = (c[:, None, None] * d[:, :, None]) * P * d[:, None, :]
        qs = c[:, None] * d * q
        g = torch.maximum(Ps.abs().amax(1).mean(1), qs.abs().amax(1))
        c = c / torch.clamp(g, min=eps)
    return d, e, c


def scale_qp(P, q, G, lo, hi, d, e, c):
    """The QP in the variables and rows scaled by (d, e, c) of
    ``_ruiz_equilibrate``: (c D P D, c D q, E G D, E lo, E hi)."""
    return ((c[:, None, None] * d[:, :, None]) * P * d[:, None, :], c[:, None] * d * q,
            e[:, :, None] * G * d[:, None, :], e * lo, e * hi)


def _polish_factor(P, G):
    """Cholesky of P and the Gram matrix H = G P^-1 G', shared by every
    active-set guess."""
    Lp = _cholesky(P)
    H = G @ torch.cholesky_solve(G.transpose(1, 2), Lp)
    return Lp, H


def _polish_masks(P, q, G, lo, hi, act_lo, act_hi, Lp, H):
    """Equality-constrained resolve on a given active-set guess via the
    Schur complement of the KKT system.

    Inactive rows contribute an identity row to S = D H D + (I - D), which
    forces their multiplier to zero and keeps S at shape (m, m). A 1e-7
    ridge keeps degenerate active sets factorizable, and one pass of
    iterative refinement through the same factors recovers the accuracy.
    """
    act = act_lo | act_hi
    d = act.to(P.dtype)
    b = torch.where(act_lo, lo, hi)
    m = G.shape[1]
    S = d[:, :, None] * H * d[:, None, :] + torch.diag_embed(1.0 - d)
    reg = 1e-7 * torch.clamp(torch.diagonal(S, dim1=1, dim2=2).amax(1), min=1.0)
    S = S + reg[:, None, None] * torch.eye(m, dtype=P.dtype, device=P.device)
    Ls = _cholesky(S)

    def psolve(L, v):
        return torch.cholesky_solve(v[..., None], L)[..., 0]

    def kkt_solve(r1, r2):
        # P dx + G'D dl = r1 ; D G dx = r2 ; (I-D) dl = 0
        Pir1 = psolve(Lp, r1)
        dl = psolve(Ls, d * _mv(G, Pir1) - r2)
        dx = Pir1 - psolve(Lp, _mtv(G, d * dl))
        return dx, dl

    xp, lam = kkt_solve(-q, d * b)
    r1 = -(q + _mv(P, xp) + _mtv(G, d * lam))
    r2 = d * (b - _mv(G, xp))
    dx, dl = kkt_solve(r1, r2)
    return xp + dx, d * (lam + dl)


def polish_and_select(P, q, G, lo, hi, sol: QPSolution, act_tol_rel=ACT_TOL_REL) -> QPSolution:
    """Two-attempt polish with a branchless select, on the unscaled ADMM
    solution ``sol`` (x, y and its primal residual); the plain version of
    the polish kernel (A/B-2, also P-B). Returns ``sol`` with x, y,
    polished and prim_res replaced.

    Attempt 1 takes the active set from the ADMM duals (the OSQP recipe);
    attempt 2 from primal proximity (|Gx - bound| small), which rescues the
    rare solve whose loosely converged dual names the wrong set. Each is
    accepted on finiteness, bound violation <= 1e-5 * span and objective.
    """
    x, y, prim = sol.x, sol.y, sol.prim_res
    Lp, H = _polish_factor(P, G)
    y_scale = torch.clamp(y.abs().amax(1), min=1.0)
    tol = act_tol_rel * y_scale[:, None]
    xp1, yp1 = _polish_masks(P, q, G, lo, hi, y < -tol, y > tol, Lp, H)

    Gx = _mv(G, x)
    ptol = 1e-3 * torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1.0)
    # a row cannot be active at both bounds; break ties toward the closer one
    near_lo = (Gx - lo <= ptol) & (Gx - lo <= hi - Gx)
    near_hi = (hi - Gx <= ptol) & (hi - Gx < Gx - lo)
    xp2, yp2 = _polish_masks(P, q, G, lo, hi, near_lo, near_hi, Lp, H)

    span = torch.clamp(hi.abs().amax(1), min=1.0)

    def objective(v):
        return 0.5 * (v * _mv(P, v)).sum(1) + (q * v).sum(1)

    obj = objective(x)

    def accept(xp, yp):
        Gxp = _mv(G, xp)
        viol = torch.maximum(Gxp - hi, lo - Gxp).amax(1)
        finite = torch.isfinite(xp).all(1) & torch.isfinite(yp).all(1)
        return finite & (viol <= 1e-5 * span) & (
            objective(xp) <= obj + 1e-6 * obj.abs() + 1e-6)

    ok1 = accept(xp1, yp1)
    ok2 = accept(xp2, yp2)
    ok = ok1 | ok2
    x_out = torch.where(ok1[:, None], xp1, torch.where(ok2[:, None], xp2, x))
    y_out = torch.where(ok1[:, None], yp1, torch.where(ok2[:, None], yp2, y))
    # report the primal infeasibility of the RETURNED x
    Gx_out = _mv(G, x_out)
    viol_out = torch.clamp(torch.maximum(Gx_out - hi, lo - Gx_out), min=0.0).amax(1)
    prim_out = torch.where(ok, viol_out, torch.maximum(prim, viol_out))
    return sol._replace(x=x_out, y=y_out, polished=ok, prim_res=prim_out)


def ruiz_admm_batched(
    P,      # (B, n, n)
    q,      # (B, n)
    G,      # (B, m, n)
    lo,     # (B, m)
    hi,     # (B, m)
    rounds: int = 10,
    iters: int = 50,
    rho0: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    warm=None,                   # None | (x0 (B, n), y0 (B, m), rho_w (B,))
    eps: float = 0.0,            # relative-residual early exit (0 = off)
    refactor_band: float = 0.0,  # rho drift band (<= 1: refactor every block)
    stall_cap: float = 0.0,      # stall-exit score cap (0 = off)
    stall_ratio: float = 0.5,    # min per-block improvement factor
    ruiz_iters: int = 10,
) -> QPSolution:
    """Ruiz + warm-started adaptive ADMM, without the polish: the plain
    version of A/B-1.

    Up to ``rounds`` blocks of ``iters`` iterations. Each scenario freezes
    once both relative residuals are below ``eps`` (or it stalls), tracks
    its own rho, and is refactorized when its rho leaves the band
    [1/band, band] around the factored one (OSQP's direct-solver policy).
    ``warm`` is the previous tick's unscaled (x, y) and final rho.

    Returns the unscaled x and y, ``polished`` all False, ``prim_res`` and
    ``dual_res`` the ADMM's own residuals on the SCALED problem
    (max|Gs x - z|, max|Ps x + qs + Gs'y|), the final rho and the check
    blocks run.
    """
    B, n = q.shape
    m = lo.shape[1]
    dtype, dev = q.dtype, q.device

    d, e, c = _ruiz_equilibrate(P, q, G, iters=ruiz_iters)
    Ps, qs, Gs, los, his = scale_qp(P, q, G, lo, hi, d, e, c)

    if warm is None:
        x = torch.zeros((B, n), dtype=dtype, device=dev)
        y = torch.zeros((B, m), dtype=dtype, device=dev)
        rho = torch.full((B,), rho0, dtype=dtype, device=dev)
    else:
        x0, y0, rho_w = warm
        x = x0 / d
        y = (c[:, None] * y0) / e
        rho = rho_w.to(dtype)
    z = torch.clamp(_mv(Gs, x), los, his)

    eye = torch.eye(n, dtype=dtype, device=dev)
    GtG = Gs.transpose(1, 2) @ Gs

    def factorize(rho_v):
        M = Ps + sigma * eye + rho_v[:, None, None] * GtG
        # explicit inverse, so the inner loop is pure matvecs
        return torch.cholesky_solve(eye.expand(B, n, n), _cholesky(M))

    rho_f = rho_p = rho
    refac = torch.ones((B,), dtype=torch.bool, device=dev)
    conv = torch.zeros((B,), dtype=torch.bool, device=dev)
    Minv = None
    prim = torch.zeros((B,), dtype=dtype, device=dev)
    dual = torch.zeros((B,), dtype=dtype, device=dev)
    checks = torch.zeros((B,), dtype=dtype, device=dev)
    prev_score = torch.full((B,), 1e30, dtype=dtype, device=dev)

    for _ in range(rounds):
        if bool(conv.all()):
            break
        rho_v = torch.where(refac, rho_p, rho_f)
        if Minv is None or bool(refac.any()):
            Minv = factorize(rho_v)
        checks = checks + (~conv).to(dtype)
        frz = conv[:, None]
        for _ in range(iters):
            rhs = sigma * x - qs + _mtv(Gs, rho_v[:, None] * z - y)
            xt = _mv(Minv, rhs)
            Gxt = _mv(Gs, xt)
            xn = alpha * xt + (1.0 - alpha) * x
            zt = alpha * Gxt + (1.0 - alpha) * z
            zn = torch.clamp(zt + y / rho_v[:, None], los, his)
            yn = y + rho_v[:, None] * (zt - zn)
            x = torch.where(frz, x, xn)
            z = torch.where(frz, z, zn)
            y = torch.where(frz, y, yn)

        # residuals + rho adaptation, per scenario
        Gx = _mv(Gs, x)
        Px = _mv(Ps, x)
        prim = torch.where(conv, prim, (Gx - z).abs().amax(1))
        dual = torch.where(conv, dual, (Px + qs + _mtv(Gs, y)).abs().amax(1))
        prim_rel = prim / torch.clamp(
            torch.maximum(Gx.abs().amax(1), z.abs().amax(1)), min=1e-6)
        dual_rel = dual / torch.clamp(
            torch.maximum(Px.abs().amax(1), qs.abs().amax(1)), min=1e-6)
        rho_n = torch.clamp(
            rho_v * torch.sqrt((prim_rel + 1e-12) / (dual_rel + 1e-12)), 1e-6, 1e6)
        rho_f = torch.where(conv, rho_f, rho_v)
        rho_p = torch.where(conv, rho_p, rho_n)
        score = torch.maximum(prim_rel, dual_rel)
        if eps > 0.0:
            conv_now = (prim_rel <= eps) & (dual_rel <= eps)
            if stall_cap > 0.0:
                # stall exit: near-converged but no longer improving, so
                # stop and let the polish finish
                conv_now = conv_now | ((score <= stall_cap)
                                       & (score > stall_ratio * prev_score)
                                       & (prim <= STALL_PRIM_CAP))
            conv = conv | conv_now
        prev_score = torch.where(conv, prev_score, score)
        if refactor_band > 1.0:
            ratio = rho_n / rho_v
            refac = ((ratio > refactor_band) | (ratio * refactor_band < 1.0)) & ~conv
        else:
            refac = ~conv

    # unscale back to the original problem
    x = d * x
    y = (e * y) / c[:, None]
    return QPSolution(x, y, torch.zeros((B,), dtype=torch.bool, device=dev), prim, dual,
                      rho=rho_f, checks=checks)


def solve_box_qp_batched(P, q, G, lo, hi, polish: bool = True, **admm) -> QPSolution:
    """Ruiz + warm-started adaptive ADMM (``ruiz_admm_batched``, which takes
    the keyword arguments) followed, unless ``polish`` is False, by the
    two-attempt polish (``polish_and_select``): the plain version of the
    fused K2 and of the two-launch A/B-1 + A/B-2. With ``polish=False`` it
    returns what the JAX package's TPU path returns
    (``solve_box_qp_lanes(polish=False)``): ``polished`` False and the
    ADMM's scaled primal residual, which the controller's ``solved`` gate
    then reads."""
    sol = ruiz_admm_batched(P, q, G, lo, hi, **admm)
    return polish_and_select(P, q, G, lo, hi, sol) if polish else sol


def kkt_residuals(P, q, G, lo, hi, x, y):
    """(stationarity, primal, complementarity) inf-norm residuals per row of
    the batch: the correctness certificate used by tests."""
    Gx = _mv(G, x)
    stat = (_mv(P, x) + q + _mtv(G, y)).abs().amax(-1)
    prim = torch.clamp(torch.maximum(Gx - hi, lo - Gx), min=0.0).amax(-1)
    comp = (torch.clamp(y, min=0.0) * (hi - Gx)).abs() + (
        torch.clamp(y, max=0.0) * (Gx - lo)).abs()
    return stat, prim, comp.amax(-1)
