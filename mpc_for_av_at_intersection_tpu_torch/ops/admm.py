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
of ``csrc/admm.cu::carve``/``carve_probe``). Past ``SMEM_LIMIT`` K2, A/B-1
and A/B-2 run a scenario on a thread-block cluster of 2-4 CTAs whose
shared memory holds it (``cluster_size``, ``rank_bytes``: the count of
``carve_split``, K2's and A/B-1's ADMM phase split by rows over the
cluster's ranks, and ``carve_polish``, the polish's, split by rows too;
K2 up to T=63, A/B-1 68, A/B-2 63); a problem no cluster holds is refused
before anything is built or launched, as is one past one CTA for the
probes.
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
MAX_CLUSTER = 4         # csrc/admm.cu: MAX_RANKS, the largest cluster a scenario takes


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


def split_floats(n: int, m: int, cluster: int) -> int:
    """Floats of each rank under ``csrc/admm.cu::carve_split``, the split
    ADMM phase of K2 and A/B-1 on ``cluster`` CTAs: P (Ps), G' and G'G and
    M^-1 on the rank's ceil(n / C) rows, G (Gs) on its ceil(m / C) rows,
    the whole ADMM matrix M (at least another rank's rows of G', which
    G'G stages there), eight n- and eight m-vectors, two sets of C
    exchange slots of max(2n, 6) floats, and red."""
    ldn, ldt = n | 1, m | 1
    pn, pm = -(-n // cluster), -(-m // cluster)
    return (pn * (3 * ldn + ldt) + pm * ldn + max(n * ldn, pn * ldt) + 8 * (n + m)
            + 2 * cluster * max(2 * n, 6) + _RED_FLOATS)


def polish_layout(n: int, m: int, cluster: int):
    """Floats of each rank before its arena under ``csrc/admm.cu::carve_polish``,
    the polish's layout (A/B-2, and K2's after its split ADMM phase) on
    ``cluster`` CTAs, the same on every rank, or None where the arena (the
    rest of the rank's ``SMEM_LIMIT``) cannot hold an attempt's active rows
    spread over the ranks at a = m: P on the rank's ceil(n / C) rows, G on its
    ceil(m / C) rows, P's factor (n x (n | 1)), twelve n- and thirteen
    m-vectors, idx, two sets of MAX_CLUSTER exchange slots and red; spread,
    an attempt takes ceil(a / C) rows of Vt_a (n | 1) and of S_aa (a | 1)
    a rank (``spread_floats``)."""
    ldn = n | 1
    pn, pm = -(-n // cluster), -(-m // cluster)
    fixed = (pn + pm + n) * ldn + 12 * n + 14 * m + 2 * MAX_CLUSTER + _RED_FLOATS
    return fixed if fixed + pm * (ldn + (m | 1)) <= SMEM_LIMIT // 4 else None


def rank_bytes(kernel: int, n: int, m: int, cluster: int) -> int:
    """Dynamic shared memory of each CTA of ``kernel`` with a scenario on
    ``cluster`` CTAs, in bytes: ``smem_bytes`` on one CTA; on a cluster,
    A/B-1's split ADMM layout (``split_floats``), and for A/B-2 and K2 (whose
    split ADMM layout and polish layout overlay each other) the whole rank,
    whose rest past the polish layout is its arena
    (``csrc/admm.cu::cluster_rank_floats``); 0 where a layout does not
    fit."""
    if cluster == 1:
        return smem_bytes(kernel, n, m)
    if kernel not in (K2, AB1, AB2) or not 2 <= cluster <= MAX_CLUSTER:
        return 0
    most = 0
    if kernel != AB2:
        most = split_floats(n, m, cluster)
        if most > SMEM_LIMIT // 4:
            return 0
    if kernel != AB1:
        # K2 hands x and y from its ADMM layout to the polish's in registers
        if kernel == K2 and (n > 256 or m > 512) or polish_layout(n, m, cluster) is None:
            return 0
        most = SMEM_LIMIT // 4     # the arena takes the rest of the rank
    return 4 * most


def cluster_size(kernel: int, n: int, m: int) -> int:
    """The CTAs a scenario of ``kernel`` takes at (n, m): 1 where one CTA's
    shared memory holds its working set, else (K2, A/B-1, A/B-2) the
    smallest cluster of 2 .. MAX_CLUSTER whose layout fits; 0 where none
    does (``csrc/admm.cu::admm_cluster_size``)."""
    if smem_bytes(kernel, n, m) <= SMEM_LIMIT:
        return 1
    return next((c for c in range(2, MAX_CLUSTER + 1) if rank_bytes(kernel, n, m, c)), 0)


def check_smem(tag: str, kernel: int, n: int, m: int) -> int:
    """The CTAs a scenario of ``kernel`` takes at (n, m) (``cluster_size``);
    raise ``ValueError`` where none holds its working set. The message
    names the horizon where m = 4T - 1, the bytes and what holds them: one
    CTA for the probes, a cluster of MAX_CLUSTER CTAs in the cluster
    layouts for K2, A/B-1 and A/B-2."""
    cluster = cluster_size(kernel, n, m)
    if cluster == 0:
        nbytes = smem_bytes(kernel, n, m)
        horizon = f" (horizon T={(m + 1) // 4})" if (m + 1) % 4 == 0 else ""
        room = (f"> {SMEM_LIMIT}" if kernel in (PROBE3, PROBE12) else
                f"that a cluster of {MAX_CLUSTER} CTAs of {SMEM_LIMIT} B ("
                f"{MAX_CLUSTER * SMEM_LIMIT} B) does not hold in its layouts")
        raise ValueError(f"{tag}: n={n}, m={m}{horizon} needs {nbytes} B of shared memory {room}")
    return cluster


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
            ruiz_iters, whole_rows=-1):
    """The kernels' host parameter arrays (``K2Params`` order, then K2's
    ``whole_rows`` on a cluster: see ``_launch_k2``)."""
    return ((ctypes.c_int * 4)(ruiz_iters, rounds, iters, whole_rows),
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
    Returns x, y, polished, prim_res, dual_res, rho, checks and
    factorizations."""
    kw = dict(rounds=rounds, iters=iters, sigma=sigma, alpha=alpha, eps=eps,
              refactor_band=refactor_band, stall_cap=stall_cap, stall_ratio=stall_ratio,
              ruiz_iters=ruiz_iters)
    if P.device.type == "cpu":
        return solve_box_qp_batched(P, q, G, lo, hi, rho0=rho0, warm=warm, **kw)
    cluster = check_smem("K2 solve_box_qp_fused", K2, q.shape[-1], lo.shape[-1])
    return _launch_k2(cluster, P, q, G, lo, hi, rho0, warm, **kw)


def _count(wrapper, cluster: int):
    wrapper.launches += 1
    if cluster > 1:
        wrapper.cluster_launches += 1


def _launch_k2(cluster, P, q, G, lo, hi, rho0, warm, whole_rows=-1, **kw) -> QPSolution:
    """K2 on CUDA tensors with a scenario on ``cluster`` CTAs: the wrapper
    passes ``check_smem``'s choice; the card tests force a cluster where
    one CTA would do, to hold the cluster instantiation to the single-CTA
    kernel bit for bit. On a cluster a polish attempt keeps at most
    ``whole_rows`` active rows whole on every rank (-1: as many as its
    arena holds) and spreads more over the ranks; the card tests pass 0 to
    drive the spread rows where they would not run."""
    B, n, m, warm = _admm_args(P, q, G, lo, hi, warm, rho0)
    lib = _build.load()
    dev = P.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty((B,) + shape, dtype=dtype, device=dev)

    x, y, ok = empty(n), empty(m), empty(dtype=torch.bool)
    prim, dual, rho, checks, facts = empty(), empty(), empty(), empty(), empty()
    with torch.cuda.device(dev):
        err = lib.k2_solve_polish(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            *(t.data_ptr() for t in warm), B, n, m, cluster,
            *_params(**kw, whole_rows=whole_rows),
            *(t.data_ptr() for t in (x, y, ok, prim, dual, rho, checks, facts)),
            _build.stream_handle(dev))
    _build.raise_on_error("K2 solve_box_qp_fused", err, cluster)
    _count(solve_box_qp_fused, cluster)
    return QPSolution(x, y, ok, prim, dual, rho=rho, checks=checks, factorizations=facts)


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
    dual residuals; rho; checks; factorizations; ``polished`` all False)."""
    kw = dict(rounds=rounds, iters=iters, sigma=sigma, alpha=alpha, eps=eps,
              refactor_band=refactor_band, stall_cap=stall_cap, stall_ratio=stall_ratio,
              ruiz_iters=ruiz_iters)
    if P.device.type == "cpu":
        return ruiz_admm_batched(P, q, G, lo, hi, rho0=rho0, warm=warm, **kw)
    cluster = check_smem("A/B-1 ruiz_admm_all_rounds", AB1, q.shape[-1], lo.shape[-1])
    return _launch_ab1(cluster, P, q, G, lo, hi, rho0, warm, **kw)


def _launch_ab1(cluster, P, q, G, lo, hi, rho0, warm, **kw) -> QPSolution:
    """A/B-1 on CUDA tensors with a scenario on ``cluster`` CTAs (as
    ``_launch_k2``)."""
    B, n, m, warm = _admm_args(P, q, G, lo, hi, warm, rho0)
    lib = _build.load()
    dev = P.device

    def empty(*shape):
        return torch.empty((B,) + shape, dtype=torch.float32, device=dev)

    x, y, prim, dual = empty(n), empty(m), empty(), empty()
    rho, checks, facts = empty(), empty(), empty()
    with torch.cuda.device(dev):
        err = lib.ruiz_admm_all_rounds(
            P.data_ptr(), G.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            *(t.data_ptr() for t in warm), B, n, m, cluster, *_params(**kw),
            *(t.data_ptr() for t in (x, y, prim, dual, rho, checks, facts)),
            _build.stream_handle(dev))
    _build.raise_on_error("A/B-1 ruiz_admm_all_rounds", err, cluster)
    _count(ruiz_admm_all_rounds, cluster)
    return QPSolution(x, y, torch.zeros((B,), dtype=torch.bool, device=dev), prim, dual,
                      rho=rho, checks=checks, factorizations=facts)


def polish_select(P, q, G, lo, hi, sol: QPSolution) -> QPSolution:
    """A/B-2: the two-attempt polish and select on the unscaled ADMM
    solution ``sol`` (its x, y and prim_res); result as
    ``polish_and_select`` (``sol`` with x, y, polished, prim_res replaced)."""
    if P.device.type == "cpu":
        return polish_and_select(P, q, G, lo, hi, sol)
    cluster = check_smem("A/B-2 polish_select", AB2, q.shape[-1], lo.shape[-1])
    return _launch_ab2(cluster, P, q, G, lo, hi, sol)


def _launch_ab2(cluster, P, q, G, lo, hi, sol: QPSolution, whole_rows=-1) -> QPSolution:
    """A/B-2 on CUDA tensors with a scenario on ``cluster`` CTAs (as
    ``_launch_k2``, ``whole_rows`` too)."""
    B, n = q.shape
    m = lo.shape[1]
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
            sol.x.data_ptr(), sol.y.data_ptr(), sol.prim_res.data_ptr(), B, n, m, cluster,
            whole_rows, ACT_TOL_REL, *(t.data_ptr() for t in (x, y, ok, prim)),
            _build.stream_handle(dev))
    _build.raise_on_error("A/B-2 polish_select", err, cluster)
    _count(polish_select, cluster)
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


# launches of each wrapper's kernel, and of those the ones on a cluster
solve_box_qp_fused.launches = solve_box_qp_fused.cluster_launches = 0
ruiz_admm_all_rounds.launches = ruiz_admm_all_rounds.cluster_launches = 0
polish_select.launches = polish_select.cluster_launches = 0
