"""Jerk-penalized (comfort) controller variant: the 5-state condensing and its tick.

Port of ``condense_jerk`` and ``mpc_step_jerk`` in
``mpc_for_av_at_intersection_tpu/mpc/jerk.py``
(reference ``main/lib/mpc_jerk.py``) with the batch written out. The model
adds an acceleration *state* x4: v_{t+1} = v_t + dt (x4_t + u0_t),
x4_{t+1} = x4_t + dt u0_t (``linearize_bicycle(nx=5)``), and penalizes its
differences (x4_{t+1} - x4_t)^2 for t < T-1. The initial accel state is
free (the reference pins only x[:4, 0], mpc_jerk.py:193), so the decision
vector is z = [u_flat; a0], 2T+1 variables, and a0 is one more column of
the prediction operator.

Since x4_{t+1} - x4_t = dt u0_t exactly and x4's affine part is zero
(x0's accel is 0 and C[4] = 0), the jerk penalty is the static diagonal
jerk_weight * dt^2 on the accel inputs u0_0..u0_{T-2}, as the JAX kernel
``ops/condense_pallas.py:189`` writes it.

Documented divergence (QUIRKS #15, kept from the JAX package): the
reference's terminal cost is a 4x4 Qf against the 5-dim state, which
crashes CVXPY whenever ``reaches_end`` fires; the intended 5x5 Qf with zero
weight on the accel state is used.
"""

from __future__ import annotations

import torch

from .condense import CondensedQP, _tracking_blocks, finish_qp, prediction_matrices
from .config import MPCConfig
from .controller import ControllerState, MPCStepOut, _step_one


def condense_jerk(A, B, C, x0, xref, reaches_end, cfg: MPCConfig) -> CondensedQP:
    """A (Bs, T, 5, 5), B (Bs, T, 5, 2), C (Bs, T, 5), x0 (Bs, 4) -> the
    condensed QP over z = [u_flat (2T); a0 (1)]."""
    T, nu, nx = cfg.T, cfg.nu, 5
    Bs = A.shape[0]
    dtype, dev = A.dtype, A.device
    ub = T * nu
    n = ub + 1

    x0_5 = torch.cat([x0, torch.zeros((Bs, 1), dtype=dtype, device=dev)], dim=1)
    row0 = torch.zeros((Bs, nx, n), dtype=dtype, device=dev)
    row0[:, 4, ub] = 1.0                              # x_0's accel state = a0
    F, g = prediction_matrices(A, B, C, x0_5, row0)   # (Bs,T,5,n), (Bs,T,5)
    Ff = F.reshape(Bs, T * nx, n)

    # tracking cost: the 4x4 blocks widened to 5x5, zero weight on x4
    Q = torch.zeros((Bs, T, nx, nx), dtype=dtype, device=dev)
    Q[:, :, :4, :4] = _tracking_blocks(xref, reaches_end, cfg)
    r = torch.cat([xref[:, :, 1:], torch.zeros((Bs, 1, T), dtype=dtype, device=dev)], dim=1)
    QF = (Q @ F).reshape(Bs, T * nx, n)
    P = Ff.transpose(1, 2) @ QF
    qvec = (QF.transpose(1, 2) @ (g.reshape(Bs, T * nx) - r.transpose(1, 2).reshape(Bs, T * nx))
            [..., None])[..., 0]

    jerk = torch.zeros((n,), dtype=dtype, device=dev)
    jerk[0:2 * (T - 1):2] = cfg.jerk_weight * (cfg.dt * cfg.dt)
    return finish_qp(P, qvec, F, g, reaches_end, cfg, extra_diag=jerk)


def mpc_step_jerk(state4, course, course_speed, valid_len, dl, cs: ControllerState,
                  cfg: MPCConfig, wheelbase: float) -> MPCStepOut:
    """Jerk-variant controller tick of one scenario (same contract as
    ``controller.mpc_step``): ``mpc_step_batched`` at B=1, whose QP build is
    K1's jerk mode on CUDA tensors and ``condense_jerk`` on CPU tensors.
    ``cs`` must come from ``init_controller_state`` of a jerk config (its
    warm ``qp_x`` is 2T+1 wide)."""
    if not cfg.jerk:
        raise ValueError("mpc_step_jerk needs a jerk config (MPCConfig.with_jerk())")
    return _step_one(state4, course, course_speed, valid_len, dl, cs, cfg, wheelbase)
