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
as its odd leading dimension. K2 and A/B-1 also run, at odd B, at the
horizons where the ADMM iteration's operands move between its register
tiles and shared memory: K2 at T=13, 20 and 31 (the largest one CTA
holds), canonical and jerk (n up to 63), A/B-1 at T=13, 20 and 37. Past
one CTA's shared memory K2, A/B-1 and A/B-2 run on a cluster of CTAs: at
T=32, 40 and 48 and jerk T=40, odd B, cold and warm, each against its
plain version as above (where the float64 reference certifies under 95% of
the rows, on the rows it certifies, at least 90%, and the solved share at
least the plain version's less 1% of the rows); forced onto clusters of
two, three and four where one CTA would do, at T=24 and 31, bit for bit
the single-CTA kernels (every rank computing its rows of the ADMM phase);
A/B-1 then A/B-2 bit for bit K2 at T=40 too. K2 and A/B-1 count the
ADMM matrices each row factorized as the plain solver counts them on the
card, on every row where the two ran the same trajectory (most rows),
one a block within a band of one, and on a forced cluster as on one CTA. On problems wider than the
controller's (m = 6n for K2 and A/B-2, 15n and 25n for A/B-1) each runs on
the cluster it is given against its plain version, and on every larger
cluster bit for bit as on that one. The multi-ego fleet tick at S=64
junctions with its conflict scan in four slices of rows is the tick with
the scan whole bit for bit, in less memory, on the plain torch scan; the
scan kernel's tick is that tick bit for bit, in no more memory. The scan
kernel equals the plain torch scan bit for bit (found, xy, frame_idx, and
the frames it walked as the plain count) over chained ticks at both
benchmark cells' shapes (1024 copies of the 8-ego junction, 10,000
standard junctions), on rows built for its edges, where the obstacles'
points exceed a CTA's shared memory, and the wrapper refuses what the
kernel does not take.
"""

import numpy as np
import pytest
import torch

import dataclasses

import chip_smoke
from chip_smoke import (
    compare_solutions,
    k3_check,
    k3_inputs,
    long_horizon_bars,
    same_bits,
    true_solution,
)
from mpc_for_av_at_intersection_tpu_torch.agents import collision
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
from mpc_for_av_at_intersection_tpu_torch.ops import admm
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
from mpc_for_av_at_intersection_tpu_torch.ops.scan import first_hit_scan
from mpc_for_av_at_intersection_tpu_torch.worlds import free_area, intersection

pytestmark = pytest.mark.cuda

WHEELBASE = bicycle_geometry().wheelbase
# the relative gap in final rho within which a kernel's row and the plain
# solver's ran the same ADMM trajectory: a new rho is computed from each
# solver's own float32 residuals, and trajectories that parted at the band's
# edges end a band's factor apart (on an NVIDIA H100, on random T=13-40
# instances: no row within 5e-2 counted other factorizations, one within
# 1e-1; 51-72% of cold rows and 84-99% of warm rows lie within 1e-2-5e-2)
RHO_SAME = 2e-2


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


def _qp_inputs(dev, B, T, seed, jerk=False, dt=None):
    states, course, speeds, valid, dls, oa, od = _scenarios(dev, B, T, seed)
    cfg = dataclasses.replace(MPCConfig.with_jerk(), T=T) if jerk else MPCConfig(T=T)
    if dt is not None:
        cfg = dataclasses.replace(cfg, dt=dt)
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


@pytest.mark.parametrize("T", [13, 20, 40])
def test_two_launch_solve_is_k2_bit_for_bit(dev, T):
    """A/B-1 then A/B-2 run K2's device code and hand over float32 through
    device memory: every output equal to K2's, cold and warm (at T=40 all
    three on clusters of two CTAs)."""
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


@pytest.mark.parametrize("T,jerk,B", [(13, False, 257), (13, True, 257), (20, False, 257),
                                      (20, True, 129), (31, False, 129), (31, True, 129)])
def test_solve_kernel_matches_plain_where_its_tiles_change(dev, T, jerk, B):
    """K2 at the horizons where the ADMM phase's operands move between its
    register tiles and shared memory: T=13 (the T=13 bucket), T=20 and
    n = 41 (the T=20 bucket, whole rows in registers), T=31 and n = 63
    (the largest K2 admits: rows and entries past the tiles), at odd B,
    cold and warm, held to its plain version as above."""
    args = _qp_inputs(dev, B, T, seed=600 + T + int(jerk), jerk=jerk)
    qp_ = build_qp(*args)
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    assert qp[1].shape == (B, 2 * T + int(jerk))
    kw = _solver_kw(T)
    x_true, cert = true_solution(qp)
    before = solve_box_qp_fused.launches
    kern = solve_box_qp_fused(*qp, **kw)
    torch.cuda.synchronize()
    assert solve_box_qp_fused.launches == before + 1
    plain = solve_box_qp_batched(*qp, **kw)
    compare_solutions(kern, plain, x_true, cert, f"K2 T={T} n={qp[1].shape[1]} B={B} cold")
    warm = (plain.x, plain.y, plain.rho)
    compare_solutions(solve_box_qp_fused(*qp, warm=warm, **kw),
                      solve_box_qp_batched(*qp, warm=warm, **kw), x_true, cert,
                      f"K2 T={T} n={qp[1].shape[1]} B={B} warm")


@pytest.mark.parametrize("T,B", [(13, 257), (20, 257), (37, 129)])
def test_admm_kernel_matches_plain_where_its_tiles_change(dev, T, B):
    """A/B-1 at T=13 and T=20 (its two buckets, four and three CTAs per SM)
    and at T=37 (the largest it admits: n = 74 > 64 rows of G' and M^-1,
    m = 147 > 64 + 64 - n rows of G, so rows and entries past the tiles),
    at odd B, cold and warm, held to ``ruiz_admm_batched`` as above. At
    T=37 the float64 reference (``true_solution``) certifies ~95% of the
    rows (122 of 129 here) and 16 blocks of unpolished ADMM leave both
    solvers far from it (neither solves 98% of the rows), so there the
    kernel is held to the plain version on the rows the reference
    certifies, at least 90% of them, and its solved share to the plain
    version's less two rows."""
    qp_ = build_qp(*_qp_inputs(dev, B, T, seed=700 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    kw = _solver_kw(T)
    x_true, cert = true_solution(qp)
    min_certified = 0.9 if T > 31 else 0.95
    before = ruiz_admm_all_rounds.launches
    kern = ruiz_admm_all_rounds(*qp, **kw)
    torch.cuda.synchronize()
    assert ruiz_admm_all_rounds.launches == before + 1
    def solved_bar(plain):
        share = float(chip_smoke.solved_mask(plain).float().mean())
        return min(0.98, share - 2 / B) if T > 31 else 0.98

    plain = ruiz_admm_batched(*qp, **kw)
    compare_solutions(kern, plain, x_true, cert, f"A/B-1 T={T} B={B} cold", min_certified,
                      solved_bar(plain))
    warm = (kern.x, kern.y, kern.rho)
    plain = ruiz_admm_batched(*qp, warm=warm, **kw)
    compare_solutions(ruiz_admm_all_rounds(*qp, warm=warm, **kw), plain, x_true, cert,
                      f"A/B-1 T={T} B={B} warm", min_certified, solved_bar(plain))


def _cluster_launches():
    return tuple(w.cluster_launches for w in (solve_box_qp_fused, ruiz_admm_all_rounds,
                                              polish_select))


@pytest.mark.parametrize("T,jerk,B", [(32, False, 2047), (40, False, 2047), (40, True, 2047),
                                      (48, False, 2047)])
def test_cluster_kernels_match_plain_past_one_cta(dev, T, jerk, B):
    """K2, A/B-1 and A/B-2 where one CTA's shared memory does not hold a
    scenario, at the slice's dt = 0.1: T=32 (K2 on two CTAs; A/B-1 and
    A/B-2 still on one), T=40 (all three on two; jerk: n = 81), T=48 (all
    three on two), at odd B, cold and warm, each
    against its plain version on the same input, held as above to the
    float64 optimum with ``chip_smoke.long_horizon_bars`` (the rule of
    ``test_admm_kernel_matches_plain_where_its_tiles_change``: where the
    reference certifies under 95% of the rows, the rows it certifies, at
    least 90%; the solved share ``chip_smoke.plain_share_bar``). B is in
    the thousands, as where the count bars (1% of the rows) were set: at
    these horizons about half the rows sit off the float64 optimum by
    > 2e-2 for both solvers, and their two counts differ by a few rows
    either way (on an NVIDIA H100 at B=513, jerk T=40: 285 against 279, one
    row past 1%)."""
    qp_ = build_qp(*_qp_inputs(dev, B, T, seed=800 + T + int(jerk), jerk=jerk, dt=0.1))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    n, m = qp[1].shape[1], qp[3].shape[1]
    sizes = tuple(admm.cluster_size(k, n, m) for k in (admm.K2, admm.AB1, admm.AB2))
    assert sizes == {32: (2, 1, 1), 40: (2, 2, 2), 48: (2, 2, 2)}[T]
    kw = _solver_kw(T)
    x_true, cert = true_solution(qp)
    tag = f"T={T} n={n} B={B}"
    before, cl = solve_box_qp_fused.launches, _cluster_launches()
    kern = solve_box_qp_fused(*qp, **kw)
    torch.cuda.synchronize()
    assert solve_box_qp_fused.launches == before + 1
    assert _cluster_launches() == (cl[0] + 1, cl[1], cl[2])
    plain = solve_box_qp_batched(*qp, **kw)
    compare_solutions(kern, plain, x_true, cert, f"K2 {tag} cold", *long_horizon_bars(plain, cert))
    warm = (plain.x, plain.y, plain.rho)
    plain = solve_box_qp_batched(*qp, warm=warm, **kw)
    compare_solutions(solve_box_qp_fused(*qp, warm=warm, **kw), plain, x_true, cert,
                      f"K2 {tag} warm", *long_horizon_bars(plain, cert))
    cl = _cluster_launches()
    ab1 = ruiz_admm_all_rounds(*qp, **kw)
    plain = ruiz_admm_batched(*qp, **kw)
    compare_solutions(ab1, plain, x_true, cert, f"A/B-1 {tag} cold",
                      *long_horizon_bars(plain, cert))
    plain = ruiz_admm_batched(*qp, warm=(ab1.x, ab1.y, ab1.rho), **kw)
    compare_solutions(ruiz_admm_all_rounds(*qp, warm=(ab1.x, ab1.y, ab1.rho), **kw), plain,
                      x_true, cert, f"A/B-1 {tag} warm", *long_horizon_bars(plain, cert))
    pk = polish_select(*qp, ab1)
    torch.cuda.synchronize()
    pp = polish_and_select(*qp, ab1)
    compare_solutions(pk, pp, x_true, cert, f"A/B-2 {tag}", *long_horizon_bars(pp, cert))
    on_cluster = [int(c > 1) for c in sizes]
    assert _cluster_launches() == (cl[0], cl[1] + 2 * on_cluster[1], cl[2] + on_cluster[2])


@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("T", [24, 31])
def test_cluster_instantiation_is_the_single_cta_kernel_bit_for_bit(dev, T, C):
    """Forced onto a cluster of C CTAs where one would do (through
    ``ops.admm._launch_k2``/``_launch_ab1``/``_launch_ab2``, which only
    tests call with a cluster size of their own), K2, A/B-1 and A/B-2 give
    the single-CTA kernels' outputs bit for bit, cold and warm: in K2 and
    A/B-1 every rank computes its rows of the ADMM phase, each entry on one
    quad in dot()'s order, and in K2's polish and A/B-2 every rank computes
    the products of its rows of P and G and repeats the attempts' steps on
    the active rows, which its arena holds whole."""
    B = 129
    qp_ = build_qp(*_qp_inputs(dev, B, T, seed=900 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    n, m = qp[1].shape[1], qp[3].shape[1]
    for k in (admm.K2, admm.AB1, admm.AB2):
        assert admm.cluster_size(k, n, m) == 1 and admm.rank_bytes(k, n, m, C) > 0
    kw = _solver_kw(T)
    full = dict(kw, sigma=1e-6, alpha=1.6)   # the wrappers' defaults, passed through
    cl = _cluster_launches()

    def same(a, b, tag):
        for name in a._fields:
            assert same_bits(getattr(a, name), getattr(b, name)), f"{tag}: {name}"

    one = solve_box_qp_fused(*qp, rho0=0.1, **kw)
    same(admm._launch_k2(C, *qp, 0.1, None, **full), one, f"K2 T={T} C={C} cold")
    warm = (one.x, one.y, one.rho)
    same(admm._launch_k2(C, *qp, 0.1, warm, **full), solve_box_qp_fused(*qp, warm=warm, **kw),
         f"K2 T={T} C={C} warm")
    ab1 = ruiz_admm_all_rounds(*qp, rho0=0.1, **kw)
    same(admm._launch_ab1(C, *qp, 0.1, None, **full), ab1, f"A/B-1 T={T} C={C} cold")
    warm = (ab1.x, ab1.y, ab1.rho)
    same(admm._launch_ab1(C, *qp, 0.1, warm, **full), ruiz_admm_all_rounds(*qp, warm=warm, **kw),
         f"A/B-1 T={T} C={C} warm")
    same(admm._launch_ab2(C, *qp, ab1), polish_select(*qp, ab1), f"A/B-2 T={T} C={C}")
    torch.cuda.synchronize()
    assert _cluster_launches() == (cl[0] + 2, cl[1] + 2, cl[2] + 1)


@pytest.mark.parametrize("T", [13, 40])
def test_kernels_count_the_factorizations_the_plain_solver_counts(dev, T):
    """``factorizations``: K2 and A/B-1 (T=13 on one CTA and forced onto a
    cluster of two, T=40 on their clusters of two at dt = 0.1) count the
    ADMM matrices each row factorized as ``ruiz_admm_batched`` counts them
    on the card, cold and warm, on every row where the two ran the same
    trajectory: the same check blocks and a final rho equal within
    RHO_SAME. Those are most of the rows. A new rho is computed from each
    solver's own float32 residuals, so its bits differ wherever a row was
    refactorized, and a row whose trajectories part at the band's edges
    ends with rho a band's factor (5) apart. Each count lies in
    [1, checks]; within a rho band of one every row counts its check
    blocks. Forced onto a cluster, K2 and A/B-1 count as on one CTA, x and
    y bit for bit."""
    B = 2047
    qp_ = build_qp(*_qp_inputs(dev, B, T, seed=700 + T, dt=0.1 if T == 40 else None))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    kw = _solver_kw(T)
    for name, kernel, plain, launch in (
            ("K2", solve_box_qp_fused, solve_box_qp_batched, admm._launch_k2),
            ("A/B-1", ruiz_admm_all_rounds, ruiz_admm_batched, admm._launch_ab1)):
        cold, ref = kernel(*qp, **kw), plain(*qp, **kw)
        warm = (ref.x, ref.y, ref.rho)
        for tag, got, want in (("cold", cold, ref),
                               ("warm", kernel(*qp, warm=warm, **kw), plain(*qp, warm=warm, **kw))):
            f, g = got.factorizations, want.factorizations
            assert bool(((f >= 1) & (f <= got.checks)).all()), f"{name} T={T} {tag}"
            same = (got.checks == want.checks) & (
                (got.rho - want.rho).abs() <= RHO_SAME * want.rho.abs())
            share = float(same.float().mean())
            assert share > 0.5, f"{name} T={T} {tag}: one trajectory on {share:.4f} of rows"
            assert torch.equal(f[same], g[same]), (
                f"{name} T={T} {tag}: {int((f[same] != g[same]).sum())} of "
                f"{int(same.sum())} rows count other factorizations")
        whole = kernel(*qp, **dict(kw, refactor_band=0.0))
        assert torch.equal(whole.factorizations, whole.checks), f"{name} T={T} band 0"
        if T == 13:
            n, m = qp[1].shape[1], qp[3].shape[1]
            assert admm.rank_bytes(admm.K2 if name == "K2" else admm.AB1, n, m, 2) > 0
            forced = launch(2, *qp, 0.1, None, **dict(kw, sigma=1e-6, alpha=1.6))
            for field in ("factorizations", "checks", "x", "y", "rho"):
                assert same_bits(getattr(forced, field), getattr(cold, field)), f"{name}: {field}"


@pytest.mark.parametrize("C", [2, 3, 4])
@pytest.mark.parametrize("T", [24, 31])
def test_cluster_polish_with_spread_rows_is_the_single_cta_kernel_bit_for_bit(dev, T, C):
    """K2's polish and A/B-2 on a cluster with every attempt's active rows
    spread over the ranks (``whole_rows=0``, which only tests pass: at the
    controller's horizons the arena holds the active rows whole up to a =
    131 at T=40, and spreads only beyond): Vt_a and S_aa by rows on their
    owners, G_a read from device memory, rank 0 factoring and solving
    through distributed shared memory. Forced onto C CTAs, K2 (cold and
    warm) and A/B-2 give the single-CTA kernels' outputs bit for bit."""
    B = 129
    qp_ = build_qp(*_qp_inputs(dev, B, T, seed=900 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    kw = _solver_kw(T)
    full = dict(kw, sigma=1e-6, alpha=1.6)
    cl = _cluster_launches()

    def same(a, b, tag):
        for name in a._fields:
            assert same_bits(getattr(a, name), getattr(b, name)), f"{tag}: {name}"

    one = solve_box_qp_fused(*qp, rho0=0.1, **kw)
    assert int(one.polished.sum()) > B // 4
    same(admm._launch_k2(C, *qp, 0.1, None, whole_rows=0, **full), one,
         f"K2 T={T} C={C} cold, spread")
    warm = (one.x, one.y, one.rho)
    same(admm._launch_k2(C, *qp, 0.1, warm, whole_rows=0, **full),
         solve_box_qp_fused(*qp, warm=warm, **kw), f"K2 T={T} C={C} warm, spread")
    ab1 = ruiz_admm_all_rounds(*qp, rho0=0.1, **kw)
    same(admm._launch_ab2(C, *qp, ab1, whole_rows=0), polish_select(*qp, ab1),
         f"A/B-2 T={T} C={C}, spread")
    torch.cuda.synchronize()
    assert _cluster_launches() == (cl[0] + 2, cl[1], cl[2] + 1)


def test_a_cluster_launch_that_cannot_run_raises(dev):
    """No fallback: forced onto a cluster too small for the working set
    (K2 at T=50 needs three CTAs), the launch is refused and raises, and no
    launch is counted."""
    P, q, G, lo, hi = chip_smoke.random_qps(3, 100, 199, seed=5, dev=dev)
    assert admm.cluster_size(admm.K2, 100, 199) == 3
    before = (solve_box_qp_fused.launches, _cluster_launches())
    with pytest.raises(RuntimeError, match="no launch on a cluster of 2 CTAs"):
        admm._launch_k2(2, P, q, G, lo, hi, 0.1, None, rounds=1, iters=5, sigma=1e-6,
                        alpha=1.6, eps=0.0, refactor_band=0.0, stall_cap=0.0, stall_ratio=0.5,
                        ruiz_iters=10)
    assert (solve_box_qp_fused.launches, _cluster_launches()) == before


def _wide_qps(B, n, m, seed, dev):
    """Feasible box-QPs wider than the controller's (m up to 25 n): P =
    ZZ'/n + I, G normal / sqrt(n), each row's box around G x0 for a random
    x0, q large enough that most of the n directions end on a bound."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(B, n, n)) / np.sqrt(n)
    P = Z @ Z.transpose(0, 2, 1) + np.eye(n)
    q = 3 * rng.normal(size=(B, n))
    G = rng.normal(size=(B, m, n)) / np.sqrt(n)
    g0 = (G @ (0.5 * rng.normal(size=(B, n, 1))))[..., 0]
    lo, hi = g0 - rng.uniform(0.1, 1.0, (B, m)), g0 + rng.uniform(0.1, 1.0, (B, m))
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in (P, q, G, lo, hi))


@pytest.mark.parametrize("kernel,n,m", [(admm.K2, 40, 240), (admm.AB1, 40, 600),
                                        (admm.AB1, 40, 1000), (admm.AB2, 40, 240)])
def test_cluster_kernels_match_plain_on_wider_problems(dev, kernel, n, m):
    """Where a rank's rows of G' outgrow the n x n matrix M that G'G stages
    them in (ceil(n / C) (m | 1) > n (n | 1)), and A/B-2 on the same
    polish layout as K2's: each kernel on the cluster ``cluster_size``
    picks against its plain version, cold and warm, held as
    ``test_cluster_kernels_match_plain_past_one_cta`` holds it, and forced
    onto each larger cluster, bit for bit its output there."""
    B = 257
    qp = _wide_qps(B, n, m, seed=n + m + kernel, dev=dev)
    C = admm.cluster_size(kernel, n, m)
    assert C == {(admm.K2, 240): 2, (admm.AB1, 600): 2, (admm.AB1, 1000): 3,
                 (admm.AB2, 240): 2}[(kernel, m)]
    kw = _solver_kw(20)
    full = dict(kw, sigma=1e-6, alpha=1.6)
    x_true, cert = true_solution(qp)
    tag = f"n={n} m={m} C={C}"
    wrapper = {admm.K2: solve_box_qp_fused, admm.AB1: ruiz_admm_all_rounds,
               admm.AB2: polish_select}[kernel]
    before = wrapper.cluster_launches
    if kernel == admm.AB2:
        ab1 = ruiz_admm_all_rounds(*qp, **kw)
        got, plain = polish_select(*qp, ab1), polish_and_select(*qp, ab1)
        compare_solutions(got, plain, x_true, cert, f"A/B-2 {tag}", *long_horizon_bars(plain, cert))
        forced = [admm._launch_ab2(c, *qp, ab1) for c in range(C + 1, admm.MAX_CLUSTER + 1)]
        launched = 1
    else:
        solve, launch, plain_solve = {
            admm.K2: (solve_box_qp_fused, admm._launch_k2, solve_box_qp_batched),
            admm.AB1: (ruiz_admm_all_rounds, admm._launch_ab1, ruiz_admm_batched)}[kernel]
        got, plain = solve(*qp, **kw), plain_solve(*qp, **kw)
        compare_solutions(got, plain, x_true, cert, f"{tag} cold", *long_horizon_bars(plain, cert))
        warm = (plain.x, plain.y, plain.rho)
        plain_w = plain_solve(*qp, warm=warm, **kw)
        compare_solutions(solve(*qp, warm=warm, **kw), plain_w, x_true, cert, f"{tag} warm",
                          *long_horizon_bars(plain_w, cert))
        forced = [launch(c, *qp, 0.1, None, **full) for c in range(C + 1, admm.MAX_CLUSTER + 1)]
        launched = 2
    torch.cuda.synchronize()
    assert wrapper.cluster_launches == before + launched + len(forced)
    assert all(admm.rank_bytes(kernel, n, m, c) > 0 for c in range(C, admm.MAX_CLUSTER + 1))
    for c, other in zip(range(C + 1, admm.MAX_CLUSTER + 1), forced):
        for name in got._fields:
            assert same_bits(getattr(other, name), getattr(got, name)), f"{tag} on {c}: {name}"


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


def test_multi_ego_fleet_tick_in_chunks_is_the_unchunked_tick_bit_for_bit(dev, monkeypatch):
    """S=64 copies of ``chip_smoke.py`` phase 22's 8-ego junction. On the
    plain torch scan (``check_collision_moving_cars_reference``), the scan
    in 4 slices of 128 rows and whole give the same bits in every state and
    telemetry field over three chained ticks, the sliced ticks' peak memory
    the lower; the scan kernel's ticks are the plain sliced ticks bit for
    bit, in no more memory. One K1 and one K2 launch a tick on every path,
    and one scan kernel launch a tick on the kernel's alone."""
    from mpc_for_av_at_intersection_tpu_torch.engine import closed_loop, multi_ego_fleet_tick

    world, st0, cfg, geom = chip_smoke.eight_ego_junction(dev)
    S, E = 64, st0.egos.shape[0]
    per_row = collision.scan_row_elements(E + cfg.n_agents, len(geom.circle_centers),
                                          cfg.frame_window, cfg.n_frames)
    worldS, stS = chip_smoke.junction_copies(world, S), chip_smoke.junction_copies(st0, S)
    plain = collision.check_collision_moving_cars_reference
    paths = {"sliced": (plain, S * E // 4), "whole": (plain, S * E),
             "kernel": (collision.check_collision_moving_cars, S * E // 4)}
    runs, peaks = {}, {}
    for name, (scan, rows) in paths.items():
        monkeypatch.setattr(collision, "SCAN_ELEMENTS", rows * per_row)
        monkeypatch.setattr(closed_loop, "check_collision_moving_cars", scan)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = (build_qp.launches, solve_box_qp_fused.launches, first_hit_scan.launches)
        st, ticks = stS, []
        for _ in range(3):
            st, tel = multi_ego_fleet_tick(worldS, st, cfg, geom)
            ticks.append((st, tel))
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
        runs[name] = tuple(ticks)
        assert (build_qp.launches - before[0], solve_box_qp_fused.launches - before[1],
                first_hit_scan.launches - before[2]) == (3, 3, 3 if name == "kernel" else 0)
    assert chip_smoke._same_tree(runs["sliced"], runs["whole"])
    assert peaks["sliced"] < peaks["whole"], peaks
    assert chip_smoke._same_tree(runs["kernel"], runs["sliced"])
    assert peaks["kernel"] <= peaks["sliced"], peaks


def _scan_against_plain(args, tag):
    """The scan kernel and the plain torch scan on the same inputs: found,
    xy and frame_idx bit for bit, frames the plain count
    (``collision.frames_walked``), one launch. Returns (kernel's result,
    the plain first-hit keys)."""
    ego, n_ego, _, _, obs, active, centers, radius, fw, n_frames = args
    before = first_hit_scan.launches
    kern = first_hit_scan(*args)
    assert first_hit_scan.launches == before + 1
    plain = collision.check_collision_moving_cars_reference(*args)
    for name in plain._fields:
        assert same_bits(getattr(kern, name), getattr(plain, name)), f"{tag}: {name}"
    walked = collision.frames_walked(ego, n_ego, obs, active, centers, radius, fw, n_frames)
    assert torch.equal(kern.frames, walked), f"{tag}: frames"
    _, first = collision._first_hits(ego, n_ego, obs, active, centers, (2.0 * radius) ** 2, fw,
                                     n_frames)
    return kern, first


@pytest.mark.parametrize("cell", ["multi_ego", "fleet"])
def test_scan_kernel_is_the_plain_scan_at_the_cells_shapes(dev, cell):
    """The conflict scans of four chained ticks at each benchmark cell's
    shape (``chip_smoke.scan_inputs``: 1024 copies of the 8-ego junction,
    8,192 rows of 10 obstacle slots, the egos moved as the cell places
    them; 10,000 standard junctions, 4 slots with 0-2 active), the kernel
    on each tick's inputs bit for bit the plain scan: hits and misses, rows
    that stop early, and rows with no active obstacle that walk no frame."""
    found, frames, idle = [], [], []
    for i, args in enumerate(chip_smoke.scan_inputs(dev, cell, ticks=4)):
        kern, _ = _scan_against_plain(args, f"{cell} tick {i}")
        found.append(kern.found)
        frames.append(kern.frames)
        idle.append(~args[5].any(dim=1))
    found, frames, idle = torch.stack(found), torch.stack(frames), torch.stack(idle)
    assert bool(found.any()) and not bool(found.all())
    assert bool((frames[found] < args[-1]).any())
    assert bool((frames[idle] == 0).all()) and bool((frames[~idle] >= 1).all())
    assert bool(idle.any()) == (cell == "fleet")


def _scan_inputs(dev, B, n_obs, n_pred, n_frames, fw, seed, N_T=24, spread=12.0):
    """B random rows (ego courses, detailed paths, obstacle predictions
    drifting through the ego's area, starting up to ``spread`` m away, 70%
    of the slots active, n_ego in [0, n_frames + 4), n_detail in [0, N_T]),
    float32 on ``dev``."""
    rng = np.random.default_rng(seed)

    def walk(shape, step):
        yaw = rng.uniform(-np.pi, np.pi, shape[:-1] + (1,)) + rng.normal(0, 0.1, shape).cumsum(-1)
        xy = (np.stack([np.cos(yaw), np.sin(yaw)], -1) * step).cumsum(-2)
        return np.concatenate([xy, yaw[..., None]], -1)

    ego = walk((B, n_frames), 0.4)
    det = walk((B, N_T), 0.4)
    obs = walk((B, n_obs, n_pred), 0.6)
    obs[..., :2] += rng.uniform(-spread, spread, (B, n_obs, 1, 2))
    t = lambda a, dtype=torch.float32: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return [t(ego), t(rng.integers(0, n_frames + 4, B), torch.int32), t(det),
            t(rng.integers(0, N_T + 1, B), torch.int32), t(obs),
            t(rng.uniform(size=(B, n_obs)) < 0.7, torch.bool),
            t([[-0.6, 0.0], [1.9, 0.0]]), 1.1, fw, n_frames]


@pytest.mark.parametrize("n_pred,fw", [(5, 2), (1, 2), (5, 20)])
def test_scan_kernel_on_edge_rows(dev, n_pred, fw):
    """Random rows and rows built for the edges: n_ego 0 and 1, no active
    obstacle (an inactive one on the ego), a hit at frame 0 and at the last
    valid frame, a hit with no hit on the detailed path (far away, and
    n_detail 0), no hit at all where slot 0, inactive, lies on the detailed
    path (key 0's point), n_ego past the frame buffer; with every shift
    clamped (n_pred 1, and frame_window 20 past the 12 frames)."""
    n_obs, n_frames = 3, 12
    args = _scan_inputs(dev, 264, n_obs, n_pred, n_frames, fw, seed=5)
    ego, n_ego, det, n_det, obs, active = args[:6]
    far = 1000.0
    obs[:9] = far
    active[:9] = False
    ego[:9, :, 0] = torch.arange(n_frames, device=dev) * 10.0
    ego[:9, :, 1:] = 0.0
    n_ego[:9] = n_frames
    n_det[:9] = det.shape[1]
    on_ego = ego[:9, 0, :2]
    # 0: n_ego 0, an obstacle on the first pose; 1: n_ego 1, likewise
    n_ego[0], n_ego[1] = 0, 1
    for r in (0, 1):
        obs[r, 1, :, :2] = on_ego[r]
        obs[r, 1, :, 2] = 0.0
        active[r, 1] = True
    # 2: an obstacle on the ego, inactive
    obs[2, 0, :, :2] = on_ego[2]
    # 3: a hit at frame 0
    obs[3, 2, :, :2] = on_ego[3]
    active[3, 2] = True
    # 4: a hit at the last valid frame only: the ego's last pose
    n_ego[4] = 10
    obs[4, 0, :, :2] = ego[4, 9, :2]
    ego[4, 10:] = ego[4, 9]
    active[4] = True
    # 5, 6: a hit, the detailed path far away, or of length 0
    obs[5:7, 1, :, :2] = on_ego[5:7, None]
    active[5:7, 1] = True
    det[5] += far / 2
    n_det[6] = 0
    # 7: no hit; slot 0, inactive, on the detailed path
    obs[7, 0, :, :2] = det[7, 20, :2]
    active[7, 1:] = True
    # 8: n_ego past the frame buffer, an active obstacle that never hits
    n_ego[8] = n_frames + 8
    active[8, 2] = True
    kern, _ = _scan_against_plain(args, f"n_pred={n_pred}, fw={fw}")
    frames = kern.frames.tolist()
    n_iter = max(10, n_pred)
    assert frames[:9] == [1, 1, 0, 1, n_iter, 1, 1, n_frames, n_frames]
    assert kern.found[:9].tolist() == [True, True, False, True, True, True, True, False, False]
    assert int(kern.frame_idx[5]) == int(kern.frame_idx[6]) == 0 and int(kern.frame_idx[7]) > 0
    assert bool(kern.found[9:].any()) and not bool(kern.found[9:].all())


def test_scan_kernel_tiles_obstacles_past_shared_memory(dev):
    """64 obstacles of 300 prediction frames (307 KB of circle points a row)
    in tiles of fewer obstacles, the best key from either tile; and 15,000
    prediction frames, where one obstacle's points exceed a CTA's shared
    memory and each point is placed from device memory."""
    from mpc_for_av_at_intersection_tpu_torch.ops import scan

    args = _scan_inputs(dev, 96, 64, 300, 300, 20, seed=7, spread=40.0)
    args[5][:] = True
    tile = scan.launch_shape(64, 2, 20, 300, 300)[1]
    assert 0 < tile < 64
    _, first = _scan_against_plain(args, "tiles")
    o = (first // (2 * 41)) % 64
    found = first_hit_scan(*args).found
    assert bool((o[found] < tile).any()) and bool((o[found] >= tile).any())

    args = _scan_inputs(dev, 8, 2, 15000, 15000, 20, seed=8)
    assert scan.launch_shape(2, 2, 20, 15000, 15000)[1] == 0
    _scan_against_plain(args, "points from device memory")


def test_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    args = _scan_inputs(dev, 16, 3, 5, 12, 2, seed=9)
    before = first_hit_scan.launches
    with pytest.raises(ValueError, match="float32"):
        first_hit_scan(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        first_hit_scan(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        first_hit_scan(*args[:4], args[4].transpose(1, 2).contiguous().transpose(1, 2), *args[5:])
    with pytest.raises(ValueError, match="CUDA"):
        first_hit_scan(*args[:6], args[6].cpu(), *args[7:])
    with pytest.raises(ValueError, match="overflow"):
        first_hit_scan(*args[:-1], 2**27)
    assert first_hit_scan.launches == before
    collision.check_collision_moving_cars(*args)
    assert first_hit_scan.launches == before + 1


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
    (``ops.admm.smem_bytes``, ``cluster_size``, ``rank_bytes``) equals the
    built library's (``admm_smem_bytes``, ``admm_cluster_size``,
    ``admm_rank_bytes``) for T = 5..70 at n = 2T and 2T + 1, and the card
    runs a cluster of each size the wrappers pick
    (``admm_active_clusters`` > 0). At each kernel's largest horizon it
    launches (K2 at T=63 on four CTAs, A/B-2 on four, A/B-1 at T=68 on
    four); one horizon past it the
    wrapper raises ``ValueError`` naming the horizon, before any launch
    (``tests/test_torch_admm_smem.py`` and ``test_torch_admm_cluster.py``
    hold the count and the limits)."""
    from mpc_for_av_at_intersection_tpu_torch.ops import _build, admm

    lib = _build.load()
    for T in range(5, 71):
        m = 4 * T - 1
        for n in (2 * T, 2 * T + 1):
            for kernel in range(5):
                assert lib.admm_smem_bytes(kernel, n, m) == admm.smem_bytes(kernel, n, m), (
                    kernel, n, m)
                C = admm.cluster_size(kernel, n, m)
                assert lib.admm_cluster_size(kernel, n, m) == C, (kernel, n, m)
                for c in range(1, admm.MAX_CLUSTER + 1):
                    assert lib.admm_rank_bytes(kernel, n, m, c) == admm.rank_bytes(
                        kernel, n, m, c), (kernel, n, m, c)
                if C > 1:
                    assert lib.admm_active_clusters(kernel, n, m, C) > 0, (kernel, n, m)
    largest = {admm.K2: 63, admm.AB1: 68, admm.AB2: 63, admm.PROBE3: 68, admm.PROBE12: 44}
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
