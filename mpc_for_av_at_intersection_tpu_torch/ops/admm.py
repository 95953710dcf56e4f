"""The QP solve of the controller tick: K2, and its two-launch twin A/B-1 + A/B-2.

- ``solve_box_qp_fused`` (K2) runs Ruiz + adaptive ADMM + polish in one
  launch of ``csrc/admm.cu::solve_polish_kernel``. Replaces
  ``mpc_for_av_at_intersection_tpu/ops/admm_pallas.py::solve_polish_fused_pallas``.
- ``ruiz_admm_all_rounds`` (A/B-1) runs Ruiz + adaptive ADMM without the
  polish (``ruiz_admm_kernel``). Replaces ``ruiz_admm_all_rounds_pallas``.
- ``polish_select`` (A/B-2) runs the two-attempt polish on an ADMM
  solution (``polish_select_kernel``). Replaces ``polish_select_pallas_lanes``
  and ``polish_select_pallas``, which launch the same TPU kernel in two
  layouts.
- ``solve_box_qp`` picks among them as the JAX ``solve_box_qp_lanes``
  does: the fused K2, A/B-1 then A/B-2 (``fused=False``), or A/B-1 alone
  (``polish=False``).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version from ``mpc/qp.py`` for CPU tensors: ``solve_box_qp_batched``,
``ruiz_admm_batched`` and ``polish_and_select``. One CTA holds one
scenario's whole working set in shared memory (``smem_bytes``, the count
of ``csrc/admm.cu::carve``/``carve_probe``); a problem whose working set
passes ``SMEM_LIMIT`` is refused before anything is built or launched.
"""

from __future__ import annotations

import ctypes

import torch

from ..mpc.qp import (
    ACT_TOL_REL,
    STALL_PRIM_CAP,
    QPSolution,
    polish_and_select,
    ruiz_admm_batched,
    solve_box_qp_batched,
)
from . import _build
from ._build import SMEM_LIMIT

# kernel numbers of csrc/admm.cu's admm_blocks_per_sm and admm_smem_bytes
K2, AB1, AB2, PROBE3, PROBE12 = range(5)
_RED_FLOATS = 8 * 4     # csrc/admm.cu: NWARPS * MAX_RED floats of reduction scratch


def smem_bytes(kernel: int, n: int, m: int) -> int:
    """Dynamic shared memory of one CTA of ``kernel`` at (n, m), in bytes:
    the working set ``csrc/admm.cu::carve`` (K2, A/B-1, A/B-2) or
    ``carve_probe`` (Probe-3; Probe-1 and -2) lays out, rows of n and m
    floats padded to odd leading dimensions."""
    ldn, ldm = n | 1, m | 1
    nn, mn = n * ldn, m * ldn
    if kernel in (PROBE3, PROBE12):
        factor = int(kernel == PROBE12)       # P, G'G, M and Y besides G and M^-1
        floats = nn * (1 + 4 * factor) + mn + 4 * n + 5 * m
    else:
        admm, pol = int(kernel != AB2), int(kernel != AB1)
        floats = (nn * (3 + 3 * admm) + 2 * mn + pol * m * ldm + n * (2 + 5 * admm + 7 * pol)
                  + m * (3 + 5 * admm + 11 * pol))
    return 4 * (floats + _RED_FLOATS)


def check_smem(tag: str, kernel: int, n: int, m: int):
    """Raise ``ValueError`` if ``kernel``'s working set at (n, m) does not
    fit one CTA's shared memory; the horizon is named where m = 4T - 1."""
    nbytes = smem_bytes(kernel, n, m)
    if nbytes > SMEM_LIMIT:
        horizon = f" (horizon T={(m + 1) // 4})" if (m + 1) % 4 == 0 else ""
        raise ValueError(f"{tag}: n={n}, m={m}{horizon} needs {nbytes} B of shared memory "
                         f"> {SMEM_LIMIT}")


def _admm_args(P, q, G, lo, hi, warm, rho0):
    """Check the problem and warm start for the kernels; a cold warm start
    is made here. Returns (B, n, m, warm)."""
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
    return B, n, m, warm


def _params(rounds, iters, sigma, alpha, eps, refactor_band, stall_cap, stall_ratio,
            ruiz_iters):
    """The kernels' host parameter arrays (``K2Params`` order)."""
    return ((ctypes.c_int * 3)(ruiz_iters, rounds, iters),
            (ctypes.c_float * 8)(sigma, alpha, eps, refactor_band, stall_cap, stall_ratio,
                                 STALL_PRIM_CAP, ACT_TOL_REL))


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
    """K2: solve a batch of box-QPs; arguments as ``ruiz_admm_batched``.
    Returns x, y, polished, prim_res, dual_res, rho and checks."""
    kw = dict(rounds=rounds, iters=iters, sigma=sigma, alpha=alpha, eps=eps,
              refactor_band=refactor_band, stall_cap=stall_cap, stall_ratio=stall_ratio,
              ruiz_iters=ruiz_iters)
    if P.device.type == "cpu":
        return solve_box_qp_batched(P, q, G, lo, hi, rho0=rho0, warm=warm, **kw)
    check_smem("K2 solve_box_qp_fused", K2, q.shape[-1], lo.shape[-1])
    B, n, m, warm = _admm_args(P, q, G, lo, hi, warm, rho0)
    lib = _build.load()
    dev = P.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty((B,) + shape, dtype=dtype, device=dev)

    x, y, ok = empty(n), empty(m), empty(dtype=torch.bool)
    prim, dual, rho, checks = empty(), empty(), empty(), empty()
    with torch.cuda.device(dev):
        err = lib.k2_solve_polish(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            *(t.data_ptr() for t in warm), B, n, m, *_params(**kw),
            *(t.data_ptr() for t in (x, y, ok, prim, dual, rho, checks)),
            _build.stream_handle(dev))
    _build.raise_on_error("K2 solve_box_qp_fused", err)
    solve_box_qp_fused.launches += 1
    return QPSolution(x, y, ok, prim, dual, rho=rho, checks=checks)


def ruiz_admm_all_rounds(
    P, q, G, lo, hi,
    rounds: int = 10,
    iters: int = 50,
    rho0: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    warm=None,
    eps: float = 0.0,
    refactor_band: float = 0.0,
    stall_cap: float = 0.0,
    stall_ratio: float = 0.5,
    ruiz_iters: int = 10,
) -> QPSolution:
    """A/B-1: Ruiz + warm-started adaptive ADMM, no polish; arguments and
    result as ``ruiz_admm_batched`` (unscaled x, y; the scaled primal and
    dual residuals; rho; checks; ``polished`` all False)."""
    kw = dict(rounds=rounds, iters=iters, sigma=sigma, alpha=alpha, eps=eps,
              refactor_band=refactor_band, stall_cap=stall_cap, stall_ratio=stall_ratio,
              ruiz_iters=ruiz_iters)
    if P.device.type == "cpu":
        return ruiz_admm_batched(P, q, G, lo, hi, rho0=rho0, warm=warm, **kw)
    check_smem("A/B-1 ruiz_admm_all_rounds", AB1, q.shape[-1], lo.shape[-1])
    B, n, m, warm = _admm_args(P, q, G, lo, hi, warm, rho0)
    lib = _build.load()
    dev = P.device

    def empty(*shape):
        return torch.empty((B,) + shape, dtype=torch.float32, device=dev)

    x, y, prim, dual, rho, checks = empty(n), empty(m), empty(), empty(), empty(), empty()
    with torch.cuda.device(dev):
        err = lib.ruiz_admm_all_rounds(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            *(t.data_ptr() for t in warm), B, n, m, *_params(**kw),
            *(t.data_ptr() for t in (x, y, prim, dual, rho, checks)),
            _build.stream_handle(dev))
    _build.raise_on_error("A/B-1 ruiz_admm_all_rounds", err)
    ruiz_admm_all_rounds.launches += 1
    return QPSolution(x, y, torch.zeros((B,), dtype=torch.bool, device=dev), prim, dual,
                      rho=rho, checks=checks)


def polish_select(P, q, G, lo, hi, sol: QPSolution) -> QPSolution:
    """A/B-2: the two-attempt polish and select on the unscaled ADMM
    solution ``sol`` (its x, y and prim_res); result as
    ``polish_and_select`` (``sol`` with x, y, polished, prim_res replaced)."""
    if P.device.type == "cpu":
        return polish_and_select(P, q, G, lo, hi, sol)
    B, n = q.shape
    m = lo.shape[1]
    check_smem("A/B-2 polish_select", AB2, n, m)
    for name, t, shape in (("P", P, (B, n, n)), ("q", q, (B, n)), ("G", G, (B, m, n)),
                           ("lo", lo, (B, m)), ("hi", hi, (B, m)), ("x", sol.x, (B, n)),
                           ("y", sol.y, (B, m)), ("prim", sol.prim_res, (B,))):
        _build.check_cuda(name, t, shape)
    lib = _build.load()
    dev = P.device
    x = torch.empty((B, n), dtype=torch.float32, device=dev)
    y = torch.empty((B, m), dtype=torch.float32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    prim = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.polish_select(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            sol.x.data_ptr(), sol.y.data_ptr(), sol.prim_res.data_ptr(), B, n, m, ACT_TOL_REL,
            *(t.data_ptr() for t in (x, y, ok, prim)), _build.stream_handle(dev))
    _build.raise_on_error("A/B-2 polish_select", err)
    polish_select.launches += 1
    return sol._replace(x=x, y=y, polished=ok, prim_res=prim)


def solve_box_qp(P, q, G, lo, hi, polish: bool = True, fused: bool = True, **admm) -> QPSolution:
    """Solve a batch of box-QPs (keyword arguments as ``ruiz_admm_batched``)
    as the JAX ``solve_box_qp_lanes`` does: K2 in one launch; with
    ``fused=False`` A/B-1 then A/B-2, bit-identical to K2 on the card; with
    ``polish=False`` A/B-1 alone."""
    if polish and fused:
        return solve_box_qp_fused(P, q, G, lo, hi, **admm)
    sol = ruiz_admm_all_rounds(P, q, G, lo, hi, **admm)
    return polish_select(P, q, G, lo, hi, sol) if polish else sol


solve_box_qp_fused.launches = 0
ruiz_admm_all_rounds.launches = 0
polish_select.launches = 0
