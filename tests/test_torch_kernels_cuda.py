"""The CUDA kernels K1 and K2 on the card, against their plain versions.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode), so they
carry the ``cuda`` marker and skip where ``torch.cuda.is_available()`` is
false. The machine with the card has no JAX, and ``tests/conftest.py``
imports it, so run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` checks the kernels at the bench size (T=20, B=4096);
these add the default horizon T=13, an odd batch and the wrappers'
refusals. Bars: K1 atol 1e-5 * max(1, |ref|max) per field (rank-1 sums
in another order than the plain version's matmuls); K2 and the tick as in
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import compare_solutions, true_solution
from mpc_for_av_at_intersection_tpu_torch.core import smooth_yaw_numpy
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched
from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

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


def _qp_inputs(dev, B, T, seed):
    states, course, speeds, valid, dls, oa, od = _scenarios(dev, B, T, seed)
    cfg = MPCConfig(T=T)
    cs = init_controller_state(cfg, device=dev, batch=B)
    ref = compute_reference(states, course, speeds, valid, dls, cs.target_idx, cs.ov,
                            cs.have_ov, T, cfg.dt)
    return (states, oa, od, ref.xref, ref.reaches_end, cfg, WHEELBASE)


@pytest.mark.parametrize("T", [13, 20])
def test_build_qp_kernel_matches_plain(dev, T):
    args = _qp_inputs(dev, 130, T, seed=T)
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


@pytest.mark.parametrize("T", [13, 20])
def test_solve_kernel_matches_plain_cold_and_warm(dev, T):
    qp_ = build_qp(*_qp_inputs(dev, 1024, T, seed=100 + T))
    qp = (qp_.P, qp_.q, qp_.G, qp_.lo, qp_.hi)
    checks, iters, eps, band, cap, ratio = MPCConfig(T=T).solver_schedule
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


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    states, oa, od, xref, re, cfg, wb = _qp_inputs(dev, 8, 13, seed=1)
    before = (build_qp.launches, solve_box_qp_fused.launches)
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
    assert (build_qp.launches, solve_box_qp_fused.launches) == (before[0] + 1, before[1])
