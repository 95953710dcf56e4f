"""Condense the horizon-T tracking QP into a dense box-constrained QP in u.

Port of ``mpc_for_av_at_intersection_tpu/mpc/condense.py`` with the batch
written out: the states are eliminated through the affine time-varying
dynamics, X = F u + g, giving

    min_u  1/2 u' P u + q' u   s.t.  lo <= G u <= hi

with u in R^{2T}, P dense 2T x 2T and G stacking the velocity rows of F,
the input boxes and the steer-rate differences (m = 4T-1 rows). Cost
blocks follow reference ``main/lib/mpc.py:156-184``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MPCConfig


class CondensedQP(NamedTuple):
    P: torch.Tensor    # (B, n, n), n = 2T (2T+1 for the jerk variant)
    q: torch.Tensor    # (B, n)
    G: torch.Tensor    # (B, 4T-1, n)
    lo: torch.Tensor   # (B, 4T-1)
    hi: torch.Tensor   # (B, 4T-1)
    F: torch.Tensor    # (B, nx*T, n) prediction matrix
    g: torch.Tensor    # (B, nx*T) affine offset (X = F z + g)


def prediction_matrices(A, B, C, x0, row0=None):
    """Forward-accumulate the prediction operator.

    A (Bs, T, nx, nx), B (Bs, T, nx, nu), C (Bs, T, nx), x0 (Bs, nx) ->
    F (Bs, T, nx, n), g (Bs, T, nx) with x_t = F[:, t-1] @ z + g[:, t-1].
    ``row0`` (Bs, nx, n) is x_0's own row of the operator (zeros, n = T*nu,
    unless given): the jerk variant makes x_0's accel state a decision.
    """
    Bs, T, nx, nu = B.shape
    row = torch.zeros((Bs, nx, T * nu), dtype=A.dtype, device=A.device) if row0 is None else row0
    gvec = x0
    F, g = [], []
    for t in range(T):
        row = A[:, t] @ row
        row[:, :, t * nu:(t + 1) * nu] = B[:, t]
        gvec = (A[:, t] @ gvec[..., None])[..., 0] + C[:, t]
        F.append(row)
        g.append(gvec)
    return torch.stack(F, dim=1), torch.stack(g, dim=1)


def _tracking_blocks(xref, reaches_end, cfg: MPCConfig):
    """(B, T, 4, 4) tracking cost blocks for t = 1..T."""
    yaw = xref[:, 3, 1:]
    c, s = torch.cos(yaw), torch.sin(yaw)
    # w_perp * M(yaw + pi/2) + w_para * M(yaw), M(a) = [[c^2, cs], [cs, s^2]]
    qxx = cfg.w_perp * s * s + cfg.w_para * c * c
    qxy = (-cfg.w_perp + cfg.w_para) * c * s
    qyy = cfg.w_perp * c * c + cfg.w_para * s * s
    Q = torch.zeros(yaw.shape + (4, 4), dtype=xref.dtype, device=xref.device)
    Q[..., 0, 0] = qxx
    Q[..., 0, 1] = qxy
    Q[..., 1, 0] = qxy
    Q[..., 1, 1] = qyy
    Q[..., 2, 2] = cfg.q_v
    Q[..., 3, 3] = cfg.q_yaw
    Qf = torch.diag(torch.tensor(cfg.qf, dtype=xref.dtype, device=xref.device) * cfg.T)
    return torch.where(reaches_end[:, 1:, None, None], Qf, Q)


def condense(A, B, C, x0, xref, reaches_end, cfg: MPCConfig) -> CondensedQP:
    """Build the dense condensed QP for a batch (canonical nx=4)."""
    T, nu, nx = cfg.T, cfg.nu, 4
    Bs = A.shape[0]
    n = T * nu

    F, g = prediction_matrices(A, B, C, x0)          # (Bs,T,nx,n), (Bs,T,nx)
    Ff = F.reshape(Bs, T * nx, n)
    gf = g.reshape(Bs, T * nx)

    # --- cost ---
    Q = _tracking_blocks(xref, reaches_end, cfg)     # (Bs, T, 4, 4)
    r = xref[:, :, 1:].transpose(1, 2).reshape(Bs, T * nx)
    QF = (Q @ F).reshape(Bs, T * nx, n)
    P = Ff.transpose(1, 2) @ QF
    qvec = (QF.transpose(1, 2) @ (gf - r)[..., None])[..., 0]
    return finish_qp(P, qvec, F, g, reaches_end, cfg)


def finish_qp(P, qvec, F, g, reaches_end, cfg: MPCConfig, extra_diag=None) -> CondensedQP:
    """Add the input and input-rate costs (and ``extra_diag`` (n,), the
    jerk variant's penalty) to the tracking cost P, q, symmetrize, and
    stack the constraints. The inputs are the first T*nu of the n decision
    variables; F (Bs, T, nx, n), g (Bs, T, nx)."""
    T, nu = cfg.T, cfg.nu
    Bs, _, nx, n = F.shape
    ub = T * nu
    dtype, dev = P.dtype, P.device

    # input cost R_t (switches on reaches_end[0..T-1])
    r_diag = torch.where(
        reaches_end[:, :T, None],
        torch.full((1, 1, 2), cfg.end_input_weight, dtype=dtype, device=dev),
        torch.tensor([[[cfg.r_accel, cfg.r_steer]]], dtype=dtype, device=dev),
    ).reshape(Bs, ub)
    P = P + torch.diag_embed(torch.nn.functional.pad(r_diag, (0, n - ub)))

    # input-rate cost via the difference operator D: (T-1)*nu x n
    eye = torch.eye(ub, n, dtype=dtype, device=dev)
    Dm = eye[nu:] - eye[:-nu]
    rd = torch.tensor([cfg.rd_accel, cfg.rd_steer], dtype=dtype, device=dev).repeat(T - 1)
    P = P + (Dm.T * rd) @ Dm
    if extra_diag is not None:
        P = P + torch.diag(extra_diag)

    P = 2.0 * (0.5 * (P + P.transpose(1, 2)))   # symmetrize; 2 matches quad_form
    qvec = 2.0 * qvec

    # --- constraints ---
    g_v = g[:, :, 2]
    G = torch.cat([
        F[:, :, 2, :],
        eye[0::2].expand(Bs, -1, -1),    # accel boxes
        eye[1::2].expand(Bs, -1, -1),    # steer boxes
        Dm[1::2].expand(Bs, -1, -1),     # steer-rate differences
    ], dim=1)
    ones_T = torch.ones((Bs, T), dtype=dtype, device=dev)
    ones_R = torch.ones((Bs, T - 1), dtype=dtype, device=dev)
    rate = cfg.max_dsteer * cfg.dt
    lo = torch.cat([cfg.min_speed - g_v, cfg.max_decel * ones_T,
                    -cfg.max_steer * ones_T, -rate * ones_R], dim=1)
    hi = torch.cat([cfg.max_speed - g_v, cfg.max_accel * ones_T,
                    cfg.max_steer * ones_T, rate * ones_R], dim=1)
    return CondensedQP(P, qvec, G, lo, hi, F.reshape(Bs, T * nx, n), g.reshape(Bs, T * nx))
