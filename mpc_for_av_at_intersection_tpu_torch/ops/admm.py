"""K2: the QP solve of the controller tick (Ruiz + adaptive ADMM + polish).

``solve_box_qp_fused`` launches the CUDA kernel ``csrc/admm.cu`` for CUDA
tensors and runs the plain PyTorch solver
``mpc/qp.py::solve_box_qp_batched`` for CPU tensors. Replaces
``mpc_for_av_at_intersection_tpu/ops/admm_pallas.py::solve_polish_fused_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from ..mpc.qp import ACT_TOL_REL, STALL_PRIM_CAP, QPSolution, solve_box_qp_batched
from . import _build


def solve_box_qp_fused(
    P, q, G, lo, hi,            # (B, n, n), (B, n), (B, m, n), (B, m), (B, m)
    rounds: int = 10,
    iters: int = 50,
    rho0: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    warm=None,                   # None | (x0 (B, n), y0 (B, m), rho_w (B,))
    eps: float = 0.0,
    refactor_band: float = 0.0,
    stall_cap: float = 0.0,
    stall_ratio: float = 0.5,
    ruiz_iters: int = 10,
) -> QPSolution:
    """Solve a batch of box-QPs; arguments as ``solve_box_qp_batched``.
    Returns x, y, polished, prim_res, dual_res, rho and checks."""
    kw = dict(rounds=rounds, iters=iters, rho0=rho0, sigma=sigma, alpha=alpha, warm=warm,
              eps=eps, refactor_band=refactor_band, stall_cap=stall_cap,
              stall_ratio=stall_ratio, ruiz_iters=ruiz_iters)
    if P.device.type == "cpu":
        return solve_box_qp_batched(P, q, G, lo, hi, **kw)
    B, n = q.shape
    m = lo.shape[1]
    dev = P.device
    if warm is None:
        warm = (torch.zeros((B, n), dtype=torch.float32, device=dev),
                torch.zeros((B, m), dtype=torch.float32, device=dev),
                torch.full((B,), rho0, dtype=torch.float32, device=dev))
    for name, t, shape in (("P", P, (B, n, n)), ("q", q, (B, n)), ("G", G, (B, m, n)),
                           ("lo", lo, (B, m)), ("hi", hi, (B, m)), ("warm x", warm[0], (B, n)),
                           ("warm y", warm[1], (B, m)), ("warm rho", warm[2], (B,))):
        _build.check_cuda(name, t, shape)

    lib = _build.load()
    iparams = (ctypes.c_int * 3)(ruiz_iters, rounds, iters)
    fparams = (ctypes.c_float * 8)(sigma, alpha, eps, refactor_band, stall_cap,
                                   stall_ratio, STALL_PRIM_CAP, ACT_TOL_REL)

    def empty(*shape, dtype=torch.float32):
        return torch.empty((B,) + shape, dtype=dtype, device=dev)

    x, y, ok = empty(n), empty(m), empty(dtype=torch.bool)
    prim, dual, rho, checks = empty(), empty(), empty(), empty()
    with torch.cuda.device(dev):
        err = lib.k2_solve_polish(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            *(t.data_ptr() for t in warm), B, n, m, iparams, fparams,
            *(t.data_ptr() for t in (x, y, ok, prim, dual, rho, checks)),
            _build.stream_handle(dev))
    _build.raise_on_error("K2 solve_box_qp_fused", err)
    solve_box_qp_fused.launches += 1
    return QPSolution(x, y, ok, prim, dual, rho=rho, checks=checks)


solve_box_qp_fused.launches = 0
