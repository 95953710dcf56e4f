"""Batched linearization of the kinematic bicycle about an operating point.

Port of ``mpc_for_av_at_intersection_tpu/mpc/linearize.py``: the closed-form
A, B, C of reference ``main/lib/mpc.py:58-79``, and the 5-state extension
of the jerk variant (``mpc_jerk.py:61-86``).
"""

from __future__ import annotations

import torch


def linearize_bicycle(vbar, phibar, deltabar, dt: float, wheelbase: float, nx: int = 4):
    """vbar, phibar, deltabar: (..., T) operating point.

    Returns A (..., T, nx, nx), B (..., T, nx, 2), C (..., T, nx) such that
    x_{t+1} = A_t x_t + B_t u_t + C_t for state (x, y, v, yaw[, a]).
    """
    cphi, sphi = torch.cos(phibar), torch.sin(phibar)
    tand = torch.tan(deltabar)
    cd2 = torch.cos(deltabar) ** 2
    lead = vbar.shape
    A = torch.zeros(lead + (nx, nx), dtype=vbar.dtype, device=vbar.device)
    A[..., range(nx), range(nx)] = 1.0
    A[..., 0, 2] = dt * cphi
    A[..., 0, 3] = -dt * vbar * sphi
    A[..., 1, 2] = dt * sphi
    A[..., 1, 3] = dt * vbar * cphi
    A[..., 3, 2] = dt * tand / wheelbase

    B = torch.zeros(lead + (nx, 2), dtype=vbar.dtype, device=vbar.device)
    B[..., 2, 0] = dt
    B[..., 3, 1] = dt * vbar / (wheelbase * cd2)

    C = torch.zeros(lead + (nx,), dtype=vbar.dtype, device=vbar.device)
    C[..., 0] = dt * vbar * sphi * phibar
    C[..., 1] = -dt * vbar * cphi * phibar
    C[..., 3] = -dt * vbar * deltabar / (wheelbase * cd2)

    if nx == 5:
        # jerk variant: a persists as a state, feeds v, and is driven by u_a
        # (reference mpc_jerk.py:66-78: A[4,4]=1, A[2,4]=dt, B[4,0]=dt)
        A[..., 2, 4] = dt
        B[..., 4, 0] = dt
    return A, B, C
