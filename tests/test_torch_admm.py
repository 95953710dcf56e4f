"""PyTorch port, K2 module: the QP solve of the controller tick.

The plain batched solver ``solve_box_qp_batched`` (Ruiz + warm-started
adaptive ADMM + two-attempt polish; the plain version of the CUDA kernel and
what ``solve_box_qp_fused`` runs on CPU tensors) is held, under the
production schedule, cold and warm-started, to:

- the JAX package's fused Pallas kernel in interpret mode
  (``solve_box_qp_lanes(fused=True)``) on random box-QPs (B=128, n=6, m=9),
  with the bars of ``tests/test_batched_solver.py:47-57``: x within 5e-4
  where both sides' polish accepted, 2e-2 elsewhere, polished counts within 4;
- the JAX XLA batched solver on condensed MPC instances at the real T=20
  shapes (n=40, m=79, B=16): in float64 decision for decision, in float32
  on the objective (see that test for why not on x);
- in float64, the sparse numpy/scipy oracle of ``tests/oracles/qp_oracle.py``
  with the bar of ``tests/test_mpc_qp.py:165``: control error < 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpc_for_av_at_intersection_tpu.mpc.qp import solve_box_qp_batched as jax_solve_batched
from mpc_for_av_at_intersection_tpu.mpc.qp import solve_box_qp_lanes
from mpc_for_av_at_intersection_tpu.ops.admm_pallas import LANES
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.condense import condense
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
    SOLVED_PRIM_MAX,
    STALL_PRIM_CAP,
    kkt_residuals,
    solve_box_qp_batched,
)
from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp_reference

from test_mpc_qp import _make_instance, _oracle_solve
from test_torch_condense_qp import _courses

torch.set_num_threads(2)

F32 = jnp.float32
CFG = MPCConfig()
CHECKS, CHECK_ITERS, EPS, BAND, STALL_CAP, STALL_RATIO = CFG.solver_schedule
# the production schedule: 16 blocks of 32, eps 1e-4, band 5, stall 1e-3/0.5, Ruiz 3
SCHEDULE = dict(rounds=CHECKS, iters=CHECK_ITERS, eps=EPS, refactor_band=BAND,
                stall_cap=STALL_CAP, stall_ratio=STALL_RATIO, ruiz_iters=CFG.admm_ruiz_iters)


def test_schedule_is_the_production_one():
    assert SCHEDULE == dict(rounds=16, iters=32, eps=1e-4, refactor_band=5.0, stall_cap=1e-3,
                            stall_ratio=0.5, ruiz_iters=3)
    # the stall guard hardcoded at mpc/qp.py:376,585 and admm_pallas.py:708
    assert STALL_PRIM_CAP == 5e-3 and SOLVED_PRIM_MAX == 1e-2


def _random_batch(rng, B, n, m):
    """The generator of tests/test_batched_solver.py:15-24, in numpy float32."""
    Z = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", Z, Z) + 0.1 * np.eye(n)
    q = rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n))
    center = rng.normal(size=(B, m))
    width = rng.uniform(0.1, 2.0, size=(B, m))
    return tuple(a.astype(np.float32) for a in (P, q, G, center - width, center + width))


def _assert_solutions_match(port, ref, atol=5e-4, loose=2e-2, count_slack=4):
    px, rx = port.x.numpy(), np.asarray(ref.x)
    both = port.polished.numpy() & np.asarray(ref.polished)
    np.testing.assert_allclose(px[both], rx[both], atol=atol)
    np.testing.assert_allclose(px[~both], rx[~both], atol=loose)
    assert abs(int(port.polished.sum()) - int(np.asarray(ref.polished).sum())) <= count_slack


def _lanes(a):
    """(B, ...) -> the Pallas lanes layout (B/128, ..., 128)."""
    B = a.shape[0]
    return jnp.moveaxis(jnp.asarray(a, F32).reshape((B // LANES, LANES) + a.shape[1:]), 1, -1)


def test_plain_solver_matches_fused_pallas_kernel_cold_and_warm():
    """The instances of tests/test_batched_solver.py's Pallas-vs-XLA test
    (seed 1, B=128, n=6, m=9), here under the production schedule."""
    rng = np.random.default_rng(1)
    B, n, m = 128, 6, 9
    qp = _random_batch(rng, B, n, m)
    lanes = tuple(_lanes(a) for a in qp)
    ref = solve_box_qp_lanes(*lanes, B0=B, fused=True, interpret=True, **SCHEDULE)
    got = solve_box_qp_batched(*(torch.as_tensor(a) for a in qp), **SCHEDULE)
    _assert_solutions_match(got, ref)
    assert int(got.polished.sum()) > B // 3

    # warm-started from the first (JAX) solve, as the next tick would be
    warm = (np.asarray(ref.x), np.asarray(ref.y), np.asarray(ref.rho))
    ref_w = solve_box_qp_lanes(*lanes, B0=B, fused=True, interpret=True,
                               warm=tuple(jnp.asarray(a, F32) for a in warm), **SCHEDULE)
    got_w = solve_box_qp_batched(*(torch.as_tensor(a) for a in qp),
                                 warm=tuple(torch.as_tensor(a) for a in warm), **SCHEDULE)
    _assert_solutions_match(got_w, ref_w)
    # a warm start from the converged solution needs no more check blocks
    assert float(got_w.checks.mean()) <= float(got.checks.mean())


def _mpc_instances(T, B, seed):
    """Condensed MPC QPs on random courses (generator of
    tests/test_batched_solver.py:96-116) around random previous controls,
    as numpy float64."""
    rng = np.random.default_rng(seed)
    N = 200
    course = _courses(rng, B, N)
    i0 = rng.integers(3, 30, size=B)
    states = np.stack([course[np.arange(B), i0, 0] + rng.normal(0, 0.2, B),
                       course[np.arange(B), i0, 1] + rng.normal(0, 0.2, B),
                       rng.uniform(0, 8, B),
                       course[np.arange(B), i0, 2] + rng.normal(0, 0.1, B)], axis=1)
    states, course = torch.as_tensor(states.astype(np.float32)), torch.as_tensor(course)
    cfg = MPCConfig(T=T)
    cs = init_controller_state(cfg, device="cpu", batch=B)
    ref = compute_reference(states, course, torch.zeros((B, N)), torch.full((B,), N, dtype=torch.int32),
                            torch.full((B,), 0.083), cs.target_idx, cs.ov, cs.have_ov, T, cfg.dt)
    oa = torch.as_tensor(rng.uniform(-2, 2, (B, T)).astype(np.float32))
    od = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, T)).astype(np.float32))
    cqp = build_qp_reference(states, oa, od, ref.xref, ref.reaches_end, cfg,
                             bicycle_geometry().wheelbase)
    return tuple(t.numpy().astype(np.float64) for t in (cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi))


def _solve_both(qp, jdtype, tdtype, warm=None):
    kw = dict(SCHEDULE)
    ref = jax_solve_batched(*(jnp.asarray(a, jdtype) for a in qp), use_pallas=False,
                            warm=None if warm is None else tuple(jnp.asarray(a, jdtype) for a in warm),
                            **kw)
    got = solve_box_qp_batched(*(torch.as_tensor(a, dtype=tdtype) for a in qp),
                               warm=None if warm is None else tuple(
                                   torch.as_tensor(np.asarray(a), dtype=tdtype) for a in warm),
                               **kw)
    return got, ref


@pytest.mark.parametrize("seed", [4])
def test_plain_solver_matches_jax_xla_at_mpc_shapes_f64(seed):
    """At the real T=20 shapes (n=40, m=79) the algorithm is compared in
    float64, where rounding cannot move a decision: same polish outcome and
    the same number of check blocks on every row, and x to 1e-9, cold and
    warm-started from the JAX solve."""
    T, B = 20, 16
    qp = _mpc_instances(T, B, seed)
    assert qp[0].shape == (B, 2 * T, 2 * T) and qp[2].shape == (B, 4 * T - 1, 2 * T)
    got, ref = _solve_both(qp, jnp.float64, torch.float64)
    got_w, ref_w = _solve_both(qp, jnp.float64, torch.float64,
                               warm=(ref.x, ref.y, ref.rho))
    for g, r in ((got, ref), (got_w, ref_w)):
        np.testing.assert_array_equal(g.polished.numpy(), np.asarray(r.polished))
        np.testing.assert_array_equal(g.checks.numpy(), np.asarray(r.checks))
        np.testing.assert_allclose(g.x.numpy(), np.asarray(r.x), atol=1e-9)
        # rho is the square root of a ratio of residuals near their floor
        np.testing.assert_allclose(g.rho.numpy(), np.asarray(r.rho), rtol=1e-4)
    assert int(got.polished.sum()) >= B // 2


def _objective(qp, x):
    P, q = qp[0], qp[1]
    return 0.5 * np.einsum("bi,bij,bj->b", x, P, x) + (q * x).sum(1)


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_solver_matches_jax_xla_at_mpc_shapes_f32(seed):
    """The same in float32. The condensed Hessian reaches a condition
    number of ~1e7 at T=20, so float32 fixes x only up to directions of
    near-zero curvature: on these instances the JAX package's own XLA and
    Pallas paths differ by up to 2.9e-3 where both polished and 0.59
    elsewhere, above the 5e-4 / 2e-2 bars. What the two f32 solvers must
    share is the polished count (within 4 of 16 rows, as the bar of
    tests/test_batched_solver.py:44) and the objective: relative gap 1e-4
    on every row, cold and warm."""
    qp = _mpc_instances(20, 16, seed)
    got, ref = _solve_both(qp, F32, torch.float32)
    got_w, ref_w = _solve_both(qp, F32, torch.float32, warm=(ref.x, ref.y, ref.rho))
    for g, r in ((got, ref), (got_w, ref_w)):
        assert abs(int(g.polished.sum()) - int(np.asarray(r.polished).sum())) <= 4
        fo = _objective(qp, np.asarray(r.x, np.float64))
        gap = np.abs(_objective(qp, g.x.numpy().astype(np.float64)) - fo) / np.maximum(1.0, np.abs(fo))
        assert gap.max() < 1e-4, gap.max()
        assert bool((g.prim_res < 1e-2).all()) == bool((np.asarray(r.prim_res) < 1e-2).all())


def test_plain_solver_f64_matches_sparse_oracle():
    """Three instances of tests/test_mpc_qp.py (mid-course with a previous
    plan, cold, near the course end) in one float64 batch, under the
    fixed budget that test gives the JAX solver."""
    cfg = MPCConfig(T=20)
    insts = [_make_instance(np.random.default_rng(100 + seed), cfg, near_end=ne, with_prev=wp)
             for seed, ne, wp in ((0, False, True), (2, False, False), (3, True, True))]
    A, Bm, C, x0, xref, re = (torch.as_tensor(np.stack(a)) for a in zip(*insts))
    cqp = condense(A, Bm, C, x0, xref, re, cfg)
    assert cqp.P.dtype == torch.float64
    sol = solve_box_qp_batched(cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi, rounds=cfg.admm_rounds,
                               iters=cfg.admm_iters, rho0=cfg.admm_rho, sigma=cfg.admm_sigma,
                               alpha=cfg.admm_alpha)
    for b, inst in enumerate(insts):
        u_ref, X_ref = _oracle_solve(*inst, cfg)
        u = sol.x[b].reshape(cfg.T, 2).numpy()
        err = np.abs(u - u_ref).max()
        assert err < 1e-5, f"instance {b}: control error {err} (polished={bool(sol.polished[b])})"
        X = (cqp.F[b] @ sol.x[b] + cqp.g[b]).reshape(cfg.T, 4).numpy()
        np.testing.assert_allclose(X, X_ref[1:], atol=1e-4)
    stat, prim, comp = kkt_residuals(cqp.P, cqp.q, cqp.G, cqp.lo, cqp.hi, sol.x, sol.y)
    assert float(prim.max()) < 1e-9 and float(stat.max()) < 1e-6


def test_fused_wrapper_on_cpu_runs_the_plain_version():
    qp = tuple(torch.as_tensor(a) for a in _random_batch(np.random.default_rng(3), 5, 6, 9))
    before = solve_box_qp_fused.launches
    got = solve_box_qp_fused(*qp, **SCHEDULE)
    want = solve_box_qp_batched(*qp, **SCHEDULE)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert solve_box_qp_fused.launches == before


@pytest.mark.parametrize("bad", ["nan_row", "indefinite"])
def test_failed_factorization_marks_the_row_not_the_batch(bad):
    """A row whose Cholesky fails comes back unpolished with a non-finite
    or flagged residual, as XLA's NaN factor does, and leaves the other
    rows exactly as a batch without it would solve them."""
    P, q, G, lo, hi = (torch.as_tensor(a) for a in _random_batch(np.random.default_rng(5), 4, 6, 9))
    P = P.clone()
    if bad == "nan_row":
        P[1, 0, 0] = float("nan")
    else:
        P[1] = -P[1]
    sol = solve_box_qp_batched(P, q, G, lo, hi, **SCHEDULE)
    assert not bool(sol.polished[1])
    assert not bool(sol.prim_res[1] < 1e-2)
    keep = torch.tensor([0, 2, 3])
    alone = solve_box_qp_batched(P[keep], q[keep], G[keep], lo[keep], hi[keep], **SCHEDULE)
    torch.testing.assert_close(sol.x[keep], alone.x, rtol=0, atol=0)
    torch.testing.assert_close(sol.polished[keep], alone.polished)
