"""PyTorch port: the two halves of the QP solve, and the unpolished controller.

``ruiz_admm_batched`` (Ruiz + adaptive ADMM, the plain version of the A/B-1
kernel) and ``polish_and_select`` (the polish, the plain version of A/B-2)
against the JAX package's two-launch Pallas pipeline in interpret mode, on
the random box-QPs of ``tests/test_batched_solver.py`` (B=128, n=6, m=9)
under the production schedule, cold and warm:

- ``solve_box_qp_lanes(fused=False)``, the polished twin: the bars of
  ``tests/test_torch_admm.py`` (x within 5e-4 where both sides' polish
  accepted, 2e-2 elsewhere, polished counts within 4);
- ``solve_box_qp_lanes(polish=False)``, A/B-1 alone: a raw ADMM iterate, so
  the loose 2e-2 bar on x, on every row whose number of check blocks is
  the same on both sides; the check counts may differ on at most 4 rows
  (the count slack of the same test), where a residual at the exit test's
  threshold rounded the other way and the iterate stopped a block earlier
  or later.

The port's split path composes to exactly its fused plain path; with
``polish=False`` the solve returns the ADMM's scaled primal residual, as the
JAX TPU path does, and the controller's ``solved`` gate reads it. The
unpolished tick in float64 matches the JAX XLA tick within 1e-7 (same
algorithm in float64; the condensed Hessian's condition number of ~1e7 at
T=20 leaves ~1e-8), over two ticks, and keeps float64 in its state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc import init_controller_state as jax_init_state
from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched as jax_mpc_step_batched
from mpc_for_av_at_intersection_tpu.mpc.qp import solve_box_qp_lanes
from mpc_for_av_at_intersection_tpu_torch.mpc import (
    MPCConfig,
    controller_state_from_numpy,
    init_controller_state,
)
from mpc_for_av_at_intersection_tpu_torch.mpc import batch
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
    SOLVED_PRIM_MAX,
    polish_and_select,
    ruiz_admm_batched,
    solve_box_qp_batched,
)
from mpc_for_av_at_intersection_tpu_torch.ops.admm import (
    polish_select,
    ruiz_admm_all_rounds,
    solve_box_qp,
    solve_box_qp_fused,
)

from test_torch_admm import F32, SCHEDULE, _assert_solutions_match, _lanes, _random_batch
from test_torch_mpc_step import WHEELBASE, _scenarios

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def instances():
    rng = np.random.default_rng(1)
    qp = _random_batch(rng, 128, 6, 9)
    return qp, tuple(_lanes(a) for a in qp), tuple(torch.as_tensor(a) for a in qp)


def _warm(ref):
    return (tuple(jnp.asarray(np.asarray(a), F32) for a in (ref.x, ref.y, ref.rho)),
            tuple(torch.as_tensor(np.array(a)) for a in (ref.x, ref.y, ref.rho)))


def test_split_plain_solver_matches_two_launch_pallas(instances):
    _, lanes, qp = instances
    ref = solve_box_qp_lanes(*lanes, B0=128, fused=False, interpret=True, **SCHEDULE)
    admm = ruiz_admm_batched(*qp, **SCHEDULE)
    got = polish_and_select(*qp, admm)
    _assert_solutions_match(got, ref)
    assert int(got.polished.sum()) > 128 // 3
    # the polish replaces x, y, polished and prim_res and keeps the rest
    for name in ("dual_res", "rho", "checks"):
        torch.testing.assert_close(getattr(got, name), getattr(admm, name), rtol=0, atol=0)

    jwarm, twarm = _warm(ref)
    ref_w = solve_box_qp_lanes(*lanes, B0=128, fused=False, interpret=True, warm=jwarm,
                               **SCHEDULE)
    got_w = polish_and_select(*qp, ruiz_admm_batched(*qp, warm=twarm, **SCHEDULE))
    _assert_solutions_match(got_w, ref_w)


def _assert_admm_match(got, ref, loose=2e-2, count_slack=4):
    checks = got.checks.numpy() == np.asarray(ref.checks)
    assert (~checks).sum() <= count_slack
    assert not bool(got.polished.any()) and not np.asarray(ref.polished).any()
    np.testing.assert_allclose(got.x.numpy()[checks], np.asarray(ref.x)[checks], atol=loose)
    solved = got.prim_res.numpy() < SOLVED_PRIM_MAX
    np.testing.assert_array_equal(solved[checks], (np.asarray(ref.prim_res) < SOLVED_PRIM_MAX)[checks])


def test_unpolished_plain_solver_matches_pallas(instances):
    _, lanes, qp = instances
    ref = solve_box_qp_lanes(*lanes, B0=128, polish=False, interpret=True, **SCHEDULE)
    got = ruiz_admm_batched(*qp, **SCHEDULE)
    _assert_admm_match(got, ref)
    jwarm, twarm = _warm(ref)
    ref_w = solve_box_qp_lanes(*lanes, B0=128, polish=False, interpret=True, warm=jwarm,
                               **SCHEDULE)
    _assert_admm_match(ruiz_admm_batched(*qp, warm=twarm, **SCHEDULE), ref_w)


@pytest.mark.parametrize("warm", [False, True])
def test_split_path_equals_fused_plain_path_on_cpu(instances, warm):
    """On CPU tensors every route of ``solve_box_qp`` is the plain solver:
    the two-launch route equals the fused one bit for bit, the unpolished
    one equals ``ruiz_admm_batched``, and no kernel launch is counted."""
    _, _, qp = instances
    w = None
    if warm:
        first = solve_box_qp_batched(*qp, **SCHEDULE)
        w = (first.x, first.y, first.rho)
    before = (solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches, polish_select.launches)
    fused = solve_box_qp(*qp, warm=w, **SCHEDULE)
    for got, want in ((solve_box_qp(*qp, fused=False, warm=w, **SCHEDULE), fused),
                      (solve_box_qp_batched(*qp, warm=w, **SCHEDULE), fused),
                      (solve_box_qp(*qp, polish=False, warm=w, **SCHEDULE),
                       ruiz_admm_batched(*qp, warm=w, **SCHEDULE)),
                      (solve_box_qp_batched(*qp, polish=False, warm=w, **SCHEDULE),
                       ruiz_admm_batched(*qp, warm=w, **SCHEDULE))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (solve_box_qp_fused.launches, ruiz_admm_all_rounds.launches,
            polish_select.launches) == before


def test_unpolished_tick_reads_the_scaled_admm_residual(monkeypatch):
    """With ``polish=False`` the tick's solve is A/B-1's plain version; its
    ``prim_res`` is the ADMM's scaled residual max|Gs x - z| (not the
    unscaled box violation of the returned x, which the JAX XLA path
    returns), and ``solved`` is exactly that residual under the gate."""
    cfg = MPCConfig(T=20, polish=False)
    args = tuple(torch.as_tensor(a) for a in _scenarios(B=16, seed=12))
    seen = []
    real = batch.solve_box_qp

    def recording(P, q, G, lo, hi, **kw):
        sol = real(P, q, G, lo, hi, **kw)
        seen.append(((P, q, G, lo, hi), kw, sol))
        return sol

    monkeypatch.setattr(batch, "solve_box_qp", recording)
    out = mpc_step_batched(*args, init_controller_state(cfg, device="cpu", batch=16), cfg,
                           WHEELBASE)
    (qp, kw, sol), = seen
    assert kw["polish"] is False and not bool(sol.polished.any())
    admm = ruiz_admm_batched(*qp, **{k: v for k, v in kw.items() if k != "polish"})
    torch.testing.assert_close(sol.prim_res, admm.prim_res, rtol=0, atol=0)
    P, q, G, lo, hi = qp
    Gx = (G @ sol.x[..., None])[..., 0]
    viol = torch.clamp(torch.maximum(Gx - hi, lo - Gx), min=0.0).amax(1)
    assert not torch.equal(viol, sol.prim_res)
    want = sol.x.isfinite().all(1) & sol.prim_res.isfinite() & (sol.prim_res < SOLVED_PRIM_MAX)
    torch.testing.assert_close(out.solved, want)
    assert bool(out.solved.all())


@pytest.mark.parametrize("T", [13, 20])
def test_unpolished_tick_matches_jax_f64(T):
    """Two float64 ticks of the unpolished controller against the JAX XLA
    tick (the second from the JAX state): controls within 1e-7,
    ``target_idx`` and ``solved`` exact, and the carried state stays in
    float64 (the port's answer to the JAX TPU path returning float32 under
    x64)."""
    jcfg, cfg = JaxMPCConfig(T=T, polish=False), MPCConfig(T=T, polish=False)
    args = tuple(a.astype(np.float64) if a.dtype == np.float32 else a
                 for a in _scenarios(B=16, seed=11))
    cs_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (16,) + x.shape),
                        jax_init_state(jcfg, jnp.float64))
    cs = init_controller_state(cfg, dtype=torch.float64, device="cpu", batch=16)
    for _ in range(2):
        ref = jax_mpc_step_batched(*(jnp.asarray(a) for a in args), cs_j, jcfg, WHEELBASE,
                                   use_pallas=False)
        got = mpc_step_batched(*(torch.as_tensor(a) for a in args), cs, cfg, WHEELBASE)
        np.testing.assert_array_equal(got.target_idx.numpy(), np.asarray(ref.target_idx))
        np.testing.assert_array_equal(got.solved.numpy(), np.asarray(ref.solved))
        np.testing.assert_allclose(got.accel.numpy(), np.asarray(ref.accel), rtol=0, atol=1e-7)
        np.testing.assert_allclose(got.steer.numpy(), np.asarray(ref.steer), rtol=0, atol=1e-7)
        for name in ("qp_x", "qp_y", "qp_rho", "oa", "accel"):
            t = getattr(got.state, name, None) if name != "accel" else got.accel
            assert t.dtype == torch.float64, name
        cs_j = ref.state
        cs = controller_state_from_numpy({k: np.asarray(v) for k, v in cs_j._asdict().items()},
                                         device="cpu")
