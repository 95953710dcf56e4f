"""The CUDA kernels on the card, against their plain versions: K1 (both
modes), K2 and its two-launch twin A/B-1 + A/B-2, K3, K4 and the profile
path's ADMM probes (Probe-1/2/3).

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode), so they
carry the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
false. The machine with the card has no JAX, and ``tests/conftest.py``
imports it, so run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` checks the kernels at the bench size (T=20, B=4096);
these add the default horizon T=13, an odd batch and the wrappers'
refusals. Bars: K1 atol 1e-5 * max(1, |ref|max) per field in both modes
(rank-1 sums in another order than the plain version's matmuls); K2,
A/B-1, A/B-2 and the tick as in ``chip_smoke.py`` (phases 5-6, 13-16),
A/B-2 also on duals that name no row and every row (accept flags agreeing
on B - B/32 rows); the two-launch solve equal to K2 bit for bit; canonical
K1, K2 and A/B-1 equal to the digests ``chip_smoke.py`` pins; K3 as in
``chip_smoke.py`` phase 7 (found identical, cost within 1e-5 relative,
trajectories within 1e-3 m), for the default
and the single-lane weights, and an expansion budget that runs out; K3
equal to its plain version in every output on a grid whose cell count is
not a multiple of the min tree's block (where marked blocks are rescanned)
and at the largest grid the planner's rule admits, and equal to the
digests ``chip_smoke.py`` pins on phases 7-8's inputs; K4's
masks exactly equal to its plain version's (both take the same cosines
and sines from torch, and K4 is built without multiply-add contraction),
alone and under the beam engine, whose results must then be equal too;
the probes as in ``chip_smoke.py`` phase 18 (``probes_vs_plain`` on random
box-QPs, an odd batch among them; ``probes_vs_float64`` on Ruiz-scaled
condensed QPs at T=13, canonical and jerk, and at the jerk variant's
n = 41, and Probe-1 equal to Probe-2 at one round bit for bit). K2 and
the probes run at odd n (27, 41) too, where a row of a matrix is as long
as its odd leading dimension.
"""

import numpy as np
import pytest
import torch

import dataclasses

import chip_smoke
from chip_smoke import compare_solutions, k3_check, k3_inputs, same_bits, true_solution
from mpc_for_av_at_intersection_tpu_torch.core import smooth_yaw_numpy
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
    _ruiz_equilibrate,
    polish_and_select,
    ruiz_admm_batched,
    scale_qp,
    solve_box_qp_batched,
)
from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
from mpc_for_av_at_intersection_tpu_torch.lattice import SearchWeights, WavefrontConfig, wavefront
from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
    polish_select,
    ruiz_admm_all_rounds,
    solve_box_qp,
    solve_box_qp_fused,
)
from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
    admm_all_rounds,
    admm_iterations,
    admm_round_full,
)
from mpc_for_av_at_intersection_tpu_torch.ops import astar
from mpc_for_av_at_intersection_tpu_torch.ops.astar import astar_search_batch, astar_search_reference
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference
from mpc_for_av_at_intersection_tpu_torch.worlds import free_area, intersection

pytestmark = pytest.mark.cuda

WHEELBASE = bicycle_geometry().wheelbase


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scenarios(dev, B, T, seed, N=300, dl=0.083):
    """Courses, states and random previous controls around them."""
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(-np.pi, np.pi, (B, 1)) + rng.normal(0, 0.01, (B, N)).cumsum(1)
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], -1) * dl, 1)
    course = np.concatenate([xy, np.stack([smooth_yaw_numpy(y) for y in yaw])[..., None]], -1)
    i0 = rng.integers(3, 40, B)
    states = np.stack([course[np.arange(B), i0, 0] + rng.normal(0, 0.2, B),
                       course[np.arange(B), i0, 1] + rng.normal(0, 0.2, B),
                       rng.uniform(0, 8, B),
                       course[np.arange(B), i0, 2] + rng.normal(0, 0.1, B)], 1)
    # shortened courses put some rows near their end (reaches_end set)
    valid = rng.integers(60, N + 1, B)
    oa, od = rng.normal(0, 1, (B, T)), rng.normal(0, 0.2, (B, T))

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (t(states), t(course), torch.zeros((B, N), device=dev), t(valid, torch.int32),
            torch.full((B,), dl, device=dev), t(oa), t(od))


def _qp_inputs(dev, B, T, seed, jerk=False):
    states, course, speeds, valid, dls, oa, od = _scenarios(dev, B, T, seed)
    cfg = dataclasses.replace(MPCConfig.with_jerk(), T=T) if jerk else MPCConfig(T=T)
    cs = init_controller_state(cfg, device=dev, batch=B)
    ref = compute_reference(states, course, speeds, valid, dls, cs.target_idx, cs.ov,
                            cs.have_ov, T, cfg.dt)
    return (states, oa, od, ref.xref, ref.reaches_end, cfg, WHEELBASE)


@pytest.mark.parametrize("T", [5, 13, 20, 30])
@pytest.mark.parametrize("jerk", [False, True])
def test_build_qp_kernel_matches_plain(dev, T, jerk):
    """At horizons whose n (10-61) makes the last register tile of P
    partial or not and F's shared-memory stride padded or not, and an odd
    batch."""
    args = _qp_inputs(dev, 129, T, seed=T, jerk=jerk)
    assert bool(args[4].any()) and not bool(args[4].all())
    before = build_qp.launches
    got = build_qp(*args)
    torch.cuda.synchronize()
    assert build_qp.launches == before + 1
    want = build_qp_reference(*args)
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert a.shape == b.shape, name
        scale = max(1.0, float(a.abs().max()))
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, f"{name}: {err} > 1e-5 * {scale}"
    # P exactly symmetric (the kernel mirrors one triangle)
    assert bool((got.P == got.P.transpose(1, 2)).all())
    n, nx = (2 * T + 1, 5) if jerk else (2 * T, 4)
    assert got.P.shape[1:] == (n, n) and got.F.shape[1:] == (nx * T, n)


def _solver_kw(T):
    checks, iters, eps, band, cap, ratio = MPCConfig(T=T).solver_schedule
    return dict(rounds=checks, iters=iters, eps=eps, refactor_band=band, stall_cap=cap,
                stall_ratio=ratio, ruiz_iters=3)


@pytest.mark.parametrize("T", [13, 20])
def test_two_launch_solve_is_k2_bit_for_bit(dev, T):
    """A/B-1 then A/B-2 run K2's device code and hand over float32 through
    device memory: every output equal to K2's, cold and warm."""
    qp_ = build_qp(*_qp_inputs(dev, 1024, T, seed=200 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    kw = _solver_kw(T)
    fused = solve_box_qp_fused(*qp, **kw)
    before = (ruiz_admm_all_rounds.launches, polish_select.launches)
    twin = solve_box_qp(*qp, fused=False, **kw)
    torch.cuda.synchronize()
    assert (ruiz_admm_all_rounds.launches, polish_select.launches) == (before[0] + 1, before[1] + 1)
    warm = (fused.x, fused.y, fused.rho)
    pairs = ((twin, fused),
             (solve_box_qp(*qp, fused=False, warm=warm, **kw), solve_box_qp_fused(*qp, warm=warm, **kw)))
    for a, b in pairs:
        for name in a._fields:
            assert same_bits(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("T", [13, 20])
def test_admm_and_polish_kernels_match_plain(dev, T):
    """A/B-1 against ``ruiz_admm_batched`` (cold and warm) and A/B-2 against
    ``polish_and_select`` on the same ADMM solution, each held to the
    float64 optimum as K2 is (``compare_solutions``)."""
    qp_ = build_qp(*_qp_inputs(dev, 1024, T, seed=300 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    kw = _solver_kw(T)
    x_true, cert = true_solution(qp)
    before = ruiz_admm_all_rounds.launches
    kern = ruiz_admm_all_rounds(*qp, **kw)
    torch.cuda.synchronize()
    assert ruiz_admm_all_rounds.launches == before + 1
    assert not bool(kern.polished.any())
    plain = ruiz_admm_batched(*qp, **kw)
    compare_solutions(kern, plain, x_true, cert, f"A/B-1 T={T} cold")
    warm = (plain.x, plain.y, plain.rho)
    compare_solutions(ruiz_admm_all_rounds(*qp, warm=warm, **kw),
                      ruiz_admm_batched(*qp, warm=warm, **kw), x_true, cert, f"A/B-1 T={T} warm")
    before = polish_select.launches
    pk = polish_select(*qp, kern)
    torch.cuda.synchronize()
    assert polish_select.launches == before + 1
    pp = polish_and_select(*qp, kern)
    compare_solutions(pk, pp, x_true, cert, f"A/B-2 T={T}")
    assert bool((pk.checks == kern.checks).all()) and bool((pk.dual_res == kern.dual_res).all())


@pytest.mark.parametrize("duals", ["none", "every", "admm"])
def test_polish_kernel_on_extreme_active_sets(dev, duals):
    """A/B-2 on A/B-1's solutions at T=20 with y replaced so that it names
    no active row (a = 0: attempt 1 is the unconstrained solve), every row
    (a = m = 79 > n: only the ridge makes the Schur block factorizable), or
    kept (the ADMM's own mix), held against ``polish_and_select`` on the
    same input as K2 is (``compare_solutions``), the accept flags agreeing
    on at least B - B/32 rows."""
    B = 1024
    qp_ = build_qp(*_qp_inputs(dev, B, 20, seed=420))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    x_true, cert = true_solution(qp)
    sol = ruiz_admm_all_rounds(*qp, **_solver_kw(20))
    if duals == "none":
        sol = sol._replace(y=torch.zeros_like(sol.y))
    elif duals == "every":
        gx = (qp[2] @ sol.x[..., None])[..., 0]
        sol = sol._replace(y=torch.where(gx - qp[3] <= qp[4] - gx, -1.0, 1.0))
    before = polish_select.launches
    pk = polish_select(*qp, sol)
    torch.cuda.synchronize()
    assert polish_select.launches == before + 1
    pp = polish_and_select(*qp, sol)
    compare_solutions(pk, pp, x_true, cert, f"A/B-2, y names {duals}")
    agree = int((pk.polished == pp.polished).sum())
    assert agree >= B - B // 32, f"accept flags agree on {agree} of {B} rows"


def test_canonical_kernels_match_their_pinned_digests(dev):
    """K1 (canonical), K2, A/B-1 and A/B-2 (on the plain solver's cold
    output, twice) give, bit for bit, the outputs pinned in
    ``chip_smoke.PINNED_DIGESTS`` on the headline tick's inputs."""
    inputs, oa, od, ref = chip_smoke.headline_inputs(dev)
    kw = chip_smoke.solver_kw(MPCConfig(T=chip_smoke.T))
    got = chip_smoke.kernel_digests(chip_smoke.k1_inputs(inputs, oa, od, ref), kw)
    assert got == chip_smoke.pinned()


@pytest.mark.parametrize("T", [13, 20])
@pytest.mark.parametrize("jerk", [False, True])
def test_solve_kernel_matches_plain_cold_and_warm(dev, T, jerk):
    """K2 against its plain version at n = 26, 40 and, with the jerk
    variant's a0 column, at odd n = 27, 41."""
    args = _qp_inputs(dev, 1024, T, seed=100 + T, jerk=jerk)
    qp_ = build_qp(*args)
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    assert qp[1].shape[1] == 2 * T + int(jerk)
    checks, iters, eps, band, cap, ratio = args[5].solver_schedule
    kw = dict(rounds=checks, iters=iters, eps=eps, refactor_band=band, stall_cap=cap,
              stall_ratio=ratio, ruiz_iters=3)
    x_true, cert = true_solution(qp)
    before = solve_box_qp_fused.launches
    kern = solve_box_qp_fused(*qp, **kw)
    torch.cuda.synchronize()
    assert solve_box_qp_fused.launches == before + 1
    plain = solve_box_qp_batched(*qp, **kw)
    compare_solutions(kern, plain, x_true, cert, f"T={T} cold")
    warm = (plain.x, plain.y, plain.rho)
    compare_solutions(solve_box_qp_fused(*qp, warm=warm, **kw),
                      solve_box_qp_batched(*qp, warm=warm, **kw), x_true, cert, f"T={T} warm")
    assert bool(kern.rho.isfinite().all()) and bool((kern.checks >= 1).all())


@pytest.mark.parametrize("T", [13, 20])
def test_tick_kernel_path_matches_plain_path(dev, T):
    """Two ticks, the second warm-started from the kernel path's state, on
    equal inputs for both paths: target_idx exact, >= 98% solved, controls
    p95 < 2e-3 (tests/test_batched_solver.py:361)."""
    states, course, speeds, valid, dls, _, _ = _scenarios(dev, 256, T, seed=7)
    cfg = MPCConfig(T=T)
    cs = init_controller_state(cfg, device=dev, batch=256)
    for tick in range(2):
        args = (states, course, speeds, valid, dls, cs, cfg, WHEELBASE)
        kern = mpc_step_batched(*args)
        plain = _mpc_step(*args, build_qp_reference, solve_box_qp_batched)
        assert bool((kern.target_idx == plain.target_idx).all())
        assert float(kern.solved.float().mean()) >= 0.98
        both = kern.solved & plain.solved
        for name in ("accel", "steer"):
            d = (getattr(kern, name) - getattr(plain, name)).abs()[both]
            assert float(d.quantile(0.95)) < 2e-3, f"tick {tick} {name}"
        cs = kern.state


@pytest.mark.parametrize("variant", ["jerk", "unpolished"])
def test_tick_variant_kernel_path_matches_plain_path(dev, variant):
    """The jerk and the unpolished controller, two ticks as above at T=13:
    the kernel path launches K1 and K2, or K1 and A/B-1 only."""
    states, course, speeds, valid, dls, _, _ = _scenarios(dev, 256, 13, seed=8)
    cfg = MPCConfig.with_jerk() if variant == "jerk" else MPCConfig(polish=False)
    cs = init_controller_state(cfg, device=dev, batch=256)
    assert cs.qp_x.shape == (256, cfg.qp_dims[0])
    for tick in range(2):
        args = (states, course, speeds, valid, dls, cs, cfg, WHEELBASE)
        before = (solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
                  polish_select.launches)
        kern = mpc_step_batched(*args)
        after = (solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
                 polish_select.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (1, 0, 0) if variant == "jerk" else (0, 1, 0))
        plain = _mpc_step(*args, build_qp_reference, solve_box_qp_batched)
        assert bool((kern.target_idx == plain.target_idx).all())
        assert float(kern.solved.float().mean()) >= 0.98
        both = kern.solved & plain.solved
        for name in ("accel", "steer"):
            d = (getattr(kern, name) - getattr(plain, name)).abs()[both]
            assert float(d.quantile(0.95)) < 2e-3, f"tick {tick} {name}"
        cs = kern.state


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    states, oa, od, xref, re, cfg, wb = _qp_inputs(dev, 8, 13, seed=1)
    before = (build_qp.launches, solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
              polish_select.launches)
    with pytest.raises(ValueError, match="float32"):
        build_qp(states.double(), oa, od, xref, re, cfg, wb)
    with pytest.raises(ValueError, match="contiguous"):
        build_qp(states, oa.t().contiguous().t(), od, xref, re, cfg, wb)
    with pytest.raises(ValueError, match="horizon"):
        build_qp(states, oa[:, :5], od[:, :5], xref, re, cfg, wb)
    qp = build_qp(states, oa, od, xref, re, cfg, wb)
    with pytest.raises(ValueError, match="shape"):
        solve_box_qp_fused(qp.P, qp.q, qp.G, qp.lo[:, :-1], qp.hi)
    with pytest.raises(ValueError, match="CUDA"):
        solve_box_qp_fused(qp.P, qp.q, qp.G, qp.lo, qp.hi,
                           warm=(qp.q.cpu(), qp.lo.cpu(), qp.q[:, 0].cpu()))
    with pytest.raises(ValueError, match="float32"):
        ruiz_admm_all_rounds(qp.P.double(), qp.q, qp.G, qp.lo, qp.hi)
    with pytest.raises(ValueError, match="shape"):
        ruiz_admm_all_rounds(qp.P, qp.q, qp.G, qp.lo, qp.hi,
                             warm=(qp.q, qp.lo[:, :-1], qp.q[:, 0].contiguous()))
    sol = solve_box_qp_batched(qp.P, qp.q, qp.G, qp.lo, qp.hi, polish=False)
    with pytest.raises(ValueError, match="shape"):
        polish_select(qp.P, qp.q, qp.G, qp.lo, qp.hi, sol._replace(y=sol.y[:, :-1]))
    with pytest.raises(ValueError, match="CUDA"):
        polish_select(qp.P, qp.q, qp.G, qp.lo, qp.hi, sol._replace(prim_res=sol.prim_res.cpu()))
    assert (build_qp.launches, solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
            polish_select.launches) == (before[0] + 1,) + before[1:]


@pytest.mark.parametrize("weights", ["modified", "single_lane"])
def test_astar_kernel_matches_plain_on_the_junctions(dev, weights):
    junctions = [intersection(turn_indicator=t, start_pos=s) for s in (1, 2, 3, 4)
                 for t in (1, 2, 3)]
    cfg = WavefrontConfig.for_scenarios(junctions, ntheta=40)
    args, prims = k3_inputs(junctions, dev, cfg)
    args = args[:-1] + (getattr(SearchWeights, weights)(),)
    before = astar_search_batch.launches
    kern = astar_search_batch(*args, max_expansions=8192)
    torch.cuda.synchronize()
    assert astar_search_batch.launches == before + 1
    plain = astar_search_reference(*args, max_expansions=8192)
    assert bool(kern.found.all())
    k3_check(weights, kern, plain, args, prims, cfg, len(junctions), 1e-5, len(junctions))
    assert kern.n_expansions.tolist() == plain.n_expansions.tolist()
    assert kern.rows_tested.tolist() == plain.rows_tested.tolist()


def test_astar_kernel_stops_at_its_budget(dev):
    sc = [free_area(goal_distance=15.0), intersection(turn_indicator=1, start_pos=2)]
    cfg = WavefrontConfig.for_scenarios(sc, ntheta=40)
    args, _ = k3_inputs(sc, dev, cfg)
    kern = astar_search_batch(*args, max_expansions=5)
    plain = astar_search_reference(*args, max_expansions=5)
    # the free area's goal pops within the budget; the junction's does not
    assert kern.found.tolist() == plain.found.tolist() == [True, False]
    assert kern.n_expansions.tolist() == plain.n_expansions.tolist()
    assert int(kern.n_expansions[1]) == 5 and int(kern.goal_cell[1]) == -1
    assert bool((kern.parent == plain.parent).all()) and bool((kern.prim == plain.prim).all())
    assert kern.rows_tested.tolist() == plain.rows_tested.tolist()
    assert int(kern.rows_tested[0]) == 0 and int(kern.rows_tested[1]) > 0


def _astar_kernel_equals_plain(dev, scenarios, cfg, weights, budget):
    """K3 and its plain version on these scenarios: every output equal, the
    parent/prim grids included (both round the same float32 steps, and both
    pop the grid's argmin with the lowest-index tie-break)."""
    args, prims = k3_inputs(scenarios, dev, cfg)
    args = args[:-1] + (weights,)
    kern = astar_search_batch(*args, max_expansions=budget)
    plain = astar_search_reference(*args, max_expansions=budget)
    torch.cuda.synchronize()
    for name in kern._fields:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    return kern


def test_astar_kernel_matches_plain_on_a_grid_not_a_multiple_of_its_block(dev):
    """A coarse grid (2 m cells, 2 heading bins: N = 5000, 39 blocks of 128
    and a partial one) under the single-lane weights, whose steering terms
    make a commit raise the f of its block's least cell, so that the
    kernel's rescan of marked blocks runs; four of the searches exhaust
    their budget."""
    junctions = [intersection(turn_indicator=t, start_pos=s) for s in (1, 2, 3, 4)
                 for t in (1, 2, 3)]
    cfg = WavefrontConfig.for_scenarios(junctions, cell=2.0, ntheta=2)
    assert cfg.n_cells % astar.level1_block(cfg.n_cells) != 0
    kern = _astar_kernel_equals_plain(dev, junctions, cfg, SearchWeights.single_lane(), 1500)
    assert 0 < int(kern.found.sum()) < len(junctions)


def test_astar_kernel_matches_plain_at_the_largest_grid_the_rule_admits(dev):
    """298 x 298 cells x 32 heading bins (2,841,728 cells; 28 bytes a cell
    within the grid rule's 80 MB, one more row and column above it): the
    widest level-1 block, 2048 cells, 1388 of them."""
    cfg = WavefrontConfig(x0=-149.0, y0=-149.0, nx=298, ny=298, ntheta=32, cell=1.0)
    per_cell, budget = wavefront._GRID_BYTES_PER_CELL, wavefront._GRID_BUDGET
    assert cfg.n_cells * per_cell <= budget < 299 * 299 * 32 * per_cell
    assert astar.level1_block(cfg.n_cells) == 2048
    junctions = [intersection(turn_indicator=t, start_pos=s) for s, t in ((1, 1), (2, 3), (4, 2))]
    kern = _astar_kernel_equals_plain(dev, junctions, cfg, SearchWeights.modified(), 2000)
    assert bool(kern.found.all())


def test_astar_kernel_gives_its_pinned_digests(dev):
    """K3's whole result on ``chip_smoke.py`` phase 7's and phase 8's inputs
    equals, bit for bit, what the version before the min tree gave."""
    assert chip_smoke.k3_digests(dev) == chip_smoke.pinned(*chip_smoke.K3_PINS)


def test_astar_wrapper_refuses_what_the_kernel_does_not_take(dev):
    sc = [free_area(goal_distance=15.0)]
    cfg = WavefrontConfig.for_scenarios(sc, ntheta=40)
    args, _ = k3_inputs(sc, dev, cfg)
    before = astar_search_batch.launches
    with pytest.raises(ValueError, match="half-plane rows"):
        astar_search_batch(torch.zeros(1, 32, 9, 3, device=dev), *args[1:], max_expansions=64)
    with pytest.raises(ValueError, match="CUDA"):
        astar_search_batch(args[0], args[1], args[2], args[3].cpu(), *args[4:],
                           max_expansions=64)
    assert astar_search_batch.launches == before


def _collision_inputs(dev, F, seed):
    """Two junctions' packed geometry and F random frontier poses each
    (``tests/test_collision_pallas.py::_frontier_poses``)."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import primitive_table, prepare_primitives
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import pack_collision
    from mpc_for_av_at_intersection_tpu_torch.worlds import compile_scenario

    geom = bicycle_geometry()
    prims = prepare_primitives(primitive_table(geom), geom)
    arrs = [compile_scenario(sc, margin=geom.radius)
            for sc in (intersection(turn_indicator=1, start_pos=4),
                       intersection(turn_indicator=2, start_pos=1))]
    rng = np.random.default_rng(seed)
    ep = np.stack([np.asarray(a.start, np.float32) + np.stack([
        rng.uniform(-20, 20, F), rng.uniform(-20, 20, F), np.zeros(F)], 1) for a in arrs])
    ep[..., 2] = rng.uniform(-np.pi, np.pi, (2, F))
    packed = pack_collision(prims.cc, prims.cc_mask,
                            torch.tensor(np.stack([a.halfplanes for a in arrs]), device=dev),
                            torch.tensor(np.stack([a.obstacle_valid for a in arrs]), device=dev))
    return torch.tensor(ep, dtype=torch.float32, device=dev), packed


@pytest.mark.parametrize("F", [256, 37, 300])
def test_collision_kernel_matches_plain(dev, F):
    """K4 against its plain version on random poses over two junctions:
    masks equal; one launch per call; a ragged last row block (37, 300)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import (
        frontier_collision,
        frontier_collision_reference,
    )

    ep, packed = _collision_inputs(dev, F, seed=F)
    before = frontier_collision.launches
    got = frontier_collision(ep, packed)
    torch.cuda.synchronize()
    assert frontier_collision.launches == before + 1
    want = frontier_collision_reference(ep, packed)
    assert got.dtype == torch.bool and got.shape == want.shape == (2, F, 9)
    assert bool((got == want).all())
    assert 0 < int(want.sum()) < want.numel()
    with pytest.raises(ValueError, match="CUDA"):
        frontier_collision(ep.cpu().to("meta"), packed)
    assert frontier_collision.launches == before + 1


def _boxes(rng, B, O, H, lo=-24.0, hi=24.0):
    """(B, O, H, 3) rows of axis-aligned boxes with corners on a 1/8 grid:
    x <= x1, -x <= -x0, y <= y1, -y <= -y0, then H - 4 rows [0, 0, -1]."""
    c0 = np.round(rng.uniform(lo, hi, (B, O, 2)) * 8) / 8
    c1 = c0 + np.round(rng.uniform(1, 8, (B, O, 2)) * 8) / 8
    rows = np.zeros((B, O, H, 3), np.float32)
    rows[..., 4:, 2] = -1.0
    rows[..., 0, :] = np.stack([np.ones_like(c1[..., 0]), 0 * c1[..., 0], -c1[..., 0]], -1)
    rows[..., 1, :] = np.stack([-np.ones_like(c0[..., 0]), 0 * c0[..., 0], c0[..., 0]], -1)
    rows[..., 2, :] = np.stack([0 * c1[..., 1], np.ones_like(c1[..., 1]), -c1[..., 1]], -1)
    rows[..., 3, :] = np.stack([0 * c0[..., 1], -np.ones_like(c0[..., 1]), c0[..., 1]], -1)
    return rows, c0, c1


def _synthetic_collision(dev, case, F, seed):
    """Poses, packed geometry and the grid of box corners for the edge
    cases of K4: no obstacle live, every slot live, the widest geometry the
    kernel takes (O = 64 slots, P*C = 256 points) and points placed exactly
    on box edges and corners (heading 0, every coordinate on a 1/8 grid, so
    each placement and row value is exact and some are exactly 0)."""
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import pack_collision

    rng = np.random.default_rng(seed)
    B, O, P, C, H = 3, 32, 9, 10, 6
    if case == "widest":
        O, P, C, H = 64, 32, 8, 8
    hp, c0, c1 = _boxes(rng, B, O, H)
    ov = {"none_live": np.zeros((B, O), bool), "all_live": np.ones((B, O), bool)}.get(
        case, rng.random((B, O)) < 0.6)
    cc = np.round(rng.uniform(-4, 4, (P, C, 2)) * 8).astype(np.float32) / 8
    cc_mask = rng.random((P, C)) < 0.9
    ep = np.zeros((B, F, 3), np.float32)
    ep[..., :2] = np.round(rng.uniform(-30, 30, (B, F, 2)) * 8) / 8
    if case == "boundary":
        # every pose puts some primitive's first point on a live box's edge
        # or corner: x exactly x0 or x1, y exactly y0 or y1 (heading 0)
        ep[..., 2] = 0.0
        for b in range(B):
            live = np.flatnonzero(ov[b])
            for f in range(F):
                o, p = rng.choice(live), rng.integers(P)
                x = (c0 if rng.random() < 0.5 else c1)[b, o, 0]
                y = (c0 if rng.random() < 0.5 else c1)[b, o, 1]
                if rng.random() < 0.5:        # an edge, not a corner
                    y = (c0[b, o, 1] + c1[b, o, 1]) / 2
                ep[b, f, :2] = (x - cc[p, 0, 0], y - cc[p, 0, 1])
                cc_mask[p, 0] = True
    else:
        ep[..., 2] = rng.uniform(-np.pi, np.pi, (B, F))
    packed = pack_collision(cc, cc_mask, torch.tensor(hp, device=dev), torch.tensor(ov, device=dev))
    return torch.tensor(ep, device=dev), packed


@pytest.mark.parametrize("case", ["none_live", "all_live", "widest", "boundary"])
def test_collision_kernel_on_edge_cases(dev, case):
    """K4 against its plain version where no obstacle is live, where every
    slot is, at O = 64 slots and P*C = 256 points (8 points a lane), and on
    points exactly on an obstacle's edge or corner (inside, as the plain
    version's <= 0 says): masks equal bit for bit."""
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import (
        frontier_collision,
        frontier_collision_reference,
    )

    ep, packed = _synthetic_collision(dev, case, 300 if case == "widest" else 64, seed=7)
    got = frontier_collision(ep, packed)
    torch.cuda.synchronize()
    want = frontier_collision_reference(ep, packed)
    assert got.shape == want.shape and bool((got == want).all())
    if case == "none_live":
        assert not bool(want.any())
    else:
        assert 0 < int(want.sum()) < want.numel()
    if case == "boundary":
        # the points on an edge count as inside: with every box shrunk by
        # one unit in the last place of each edge's offset, they fall
        # outside and some flags change, in both versions alike
        from mpc_for_av_at_intersection_tpu_torch.ops.collision import pack_collision

        hp = packed.hp.clone()
        hp[..., :4, 2] = torch.nextafter(hp[..., :4, 2], torch.full_like(hp[..., :4, 2], 1e9))
        shrunk = pack_collision(packed.cc.reshape(packed.n_prims, -1, 2).cpu().numpy(),
                                packed.cc_mask.reshape(packed.n_prims, -1).cpu().numpy(),
                                hp, packed.ov)
        moved = frontier_collision(ep, shrunk)
        assert bool((moved == frontier_collision_reference(ep, shrunk)).all())
        assert bool((moved != got).any())


def test_beam_with_the_kernel_matches_the_plain_collision(dev):
    """The beam engine on three junctions with K4 and with its plain
    version: equal results; K4 launched once per iteration."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import plan_courses_device
    from mpc_for_av_at_intersection_tpu_torch.ops.collision import frontier_collision

    scen = [intersection(turn_indicator=t, start_pos=s) for s, t in ((1, 1), (2, 3), (4, 2))]
    cfg = WavefrontConfig.for_scenarios(scen)
    before = frontier_collision.launches
    kern = plan_courses_device(scen, bicycle_geometry(), cfg=cfg, engine="beam",
                               collision="kernel", device=dev)
    torch.cuda.synchronize()
    assert frontier_collision.launches == before + cfg.iters
    plain = plan_courses_device(scen, bicycle_geometry(), cfg=cfg, engine="beam",
                                collision="plain", device=dev)
    assert frontier_collision.launches == before + cfg.iters
    assert bool(kern.found.all())
    for name in ("found", "cost", "n_edges", "n_points", "oob", "trajectory"):
        assert bool((getattr(kern, name) == getattr(plain, name)).all()), name


def _probe_launches():
    return (admm_iterations.launches, admm_round_full.launches, admm_all_rounds.launches)


@pytest.mark.parametrize("B", [1024, 129])
def test_probe_kernels_match_plain_on_random_qps(dev, B):
    qp = chip_smoke.random_qps(B, 6, 9, seed=B, dev=dev)
    before = _probe_launches()
    failures, _ = chip_smoke.probes_vs_plain(qp, MPCConfig(), f"random QPs B={B}")
    assert not failures, failures
    # cold and warm, each kernel
    assert tuple(a - b for a, b in zip(_probe_launches(), before)) == (2, 2, 2)


def _probes_on_condensed_qp(dev, T, jerk):
    args = _qp_inputs(dev, 1024, T, seed=500, jerk=jerk)
    qp_ = build_qp(*args)
    scaled = scale_qp(qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi,
                      *_ruiz_equilibrate(qp_.P, qp_.q, qp_.G))
    assert scaled[1].shape[1] == 2 * T + int(jerk)
    before = _probe_launches()
    failures = chip_smoke.probes_vs_float64(scaled, args[5], f"T={T} jerk={jerk}")
    assert not failures, failures
    # each once against plain; Probe-1 and Probe-2 once more at one round
    assert tuple(a - b for a, b in zip(_probe_launches(), before)) == (1, 2, 2)


@pytest.mark.parametrize("jerk", [False, True])
def test_probe_kernels_match_plain_at_T13(dev, jerk):
    """At n = 26 and, with the jerk variant's a0 column, odd n = 27."""
    _probes_on_condensed_qp(dev, 13, jerk)


def test_probe_kernels_match_plain_at_jerk_n41(dev):
    """At the jerk variant's headline width, odd n = 41, m = 79: a row as
    long as its odd leading dimension."""
    _probes_on_condensed_qp(dev, 20, True)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    P, q, G, lo, hi = chip_smoke.random_qps(8, 6, 9, seed=1, dev=dev)
    rho = torch.full((8,), 0.1, device=dev)
    x, z, y = torch.zeros(8, 6, device=dev), torch.zeros(8, 9, device=dev), torch.zeros(8, 9, device=dev)
    before = _probe_launches()
    with pytest.raises(ValueError, match="float32"):
        admm_iterations(P.double(), G, q, lo, hi, rho, x, z, y, 10, 1e-6, 1.6)
    with pytest.raises(ValueError, match="shape"):
        admm_round_full(P, G, q, lo[:, :-1], hi, rho, x, z, y, 10, 1e-6, 1.6)
    with pytest.raises(ValueError, match="contiguous"):
        admm_all_rounds(P.transpose(1, 2), G, q, lo, hi, rho, x, z, y, 3, 10, 1e-6, 1.6)
    with pytest.raises(ValueError, match="CUDA"):
        admm_all_rounds(P, G, q, lo, hi, rho.cpu(), x, z, y, 3, 10, 1e-6, 1.6)
    with pytest.raises(ValueError, match="shape"):
        admm_iterations(P, G, q, lo, hi, rho[:4], x, z, y, 10, 1e-6, 1.6)
    assert _probe_launches() == before


def test_admm_shared_memory_count_and_refusal(dev):
    """The wrappers' count of the ADMM kernels' shared memory
    (``ops.admm.smem_bytes``) equals the built library's
    (``admm_smem_bytes``) for T = 5..40 at n = 2T and 2T + 1. At each
    kernel's largest horizon that fits it launches; one horizon past it the
    wrapper raises ``ValueError`` naming the horizon, before any launch
    (``tests/test_torch_admm_smem.py`` holds the count and the limits)."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, admm

    lib = _build.load()
    for T in range(5, 41):
        m = 4 * T - 1
        for n in (2 * T, 2 * T + 1):
            for kernel in range(5):
                assert lib.admm_smem_bytes(kernel, n, m) == admm.smem_bytes(kernel, n, m), (
                    kernel, n, m)
    largest = {admm.K2: 31, admm.AB1: 37, admm.AB2: 35, admm.PROBE3: 68, admm.PROBE12: 44}
    wrappers = (solve_box_qp_fused, ruiz_admm_all_rounds, polish_select, admm_iterations,
                admm_round_full, admm_all_rounds)

    def call(kernel, T):
        P, q, G, lo, hi = chip_smoke.random_qps(2, 2 * T, 4 * T - 1, seed=T, dev=dev)
        rho = torch.full((2,), 0.1, device=dev)
        x, z = torch.zeros_like(q), torch.zeros_like(lo)
        if kernel == admm.K2:
            return solve_box_qp_fused(P, q, G, lo, hi, rounds=1, iters=5)
        if kernel == admm.AB1:
            return ruiz_admm_all_rounds(P, q, G, lo, hi, rounds=1, iters=5)
        if kernel == admm.AB2:
            sol = solve_box_qp_batched(P, q, G, lo, hi, rounds=1, iters=5, polish=False)
            return polish_select(P, q, G, lo, hi, sol)
        if kernel == admm.PROBE3:
            return admm_iterations(P, G, q, lo, hi, rho, x, z, z, 5, 1e-6, 1.6)
        admm_all_rounds(P, G, q, lo, hi, rho, x, z, z, 2, 5, 1e-6, 1.6)
        return admm_round_full(P, G, q, lo, hi, rho, x, z, z, 5, 1e-6, 1.6)

    for kernel, T in largest.items():
        before = [w.launches for w in wrappers]
        out = call(kernel, T)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out[0]).all()), kernel
        assert sum(w.launches for w in wrappers) - sum(before) == (2 if kernel == admm.PROBE12
                                                                    else 1)
        before = [w.launches for w in wrappers]
        with pytest.raises(ValueError, match=f"horizon T={T + 1}"):
            call(kernel, T + 1)
        assert [w.launches for w in wrappers] == before
