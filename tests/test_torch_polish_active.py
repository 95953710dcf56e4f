"""The premise of the polish kernel's design (``csrc/admm.cu::polish_attempt``):
the Schur system built, factored and solved on the active rows only gives
the polish of the full masked system.

``mpc/qp.py::_polish_masks`` (the port's plain version, and the JAX
package's, vmapped) factors the full m x m matrix S = D H D + (I - D),
H = G P^-1 G', whose inactive rows are identity rows. The compacted solve
below does what the kernel does: it lists the active rows in ascending
order, takes their block S_aa of S with the full S's ridge
1e-7 max(max diag, 1), factors it, runs the two KKT solves (one
refinement pass) on vectors over the a rows and scatters y back with
exact zeros elsewhere. Active sets: a = 0 (the unconstrained
x = -P^-1 q), a = 1, the set the ADMM duals name, and a = m (every row,
the ridge carrying the degenerate set); on random box-QPs at the T=5
shape (n = 10, m = 19) and on condensed QPs of the headline generator
(``chip_smoke.bench_inputs``) at T=20 (n = 40, m = 79), in float64.

Bar: x and y equal to 1e-10 relative to max(1, max|.|) of the scenario,
or to 4 kappa eps where that is larger, kappa the condition number of
S_aa + ridge. Where a > n, S_aa is singular and only the ridge makes it
factorizable (kappa ~ 1e7), and any two float64 implementations differ by
about kappa eps: the port's and the JAX package's full solves are 2.2e-9
apart on the headline QPs at a = m.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from mpc_for_av_at_intersection_tpu.mpc.qp import _polish_factor as jax_polish_factor
from mpc_for_av_at_intersection_tpu.mpc.qp import _polish_masks as jax_polish_masks
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import (
    ACT_TOL_REL,
    _polish_factor,
    _polish_masks,
    ruiz_admm_batched,
)
from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp_reference

F64 = torch.float64
B_SMALL = 6


def _random_qps():
    """Random box-QPs at the T=5 shape (n = 2T, m = 4T - 1)."""
    return tuple(t.to(F64) for t in chip_smoke.random_qps(B_SMALL, 10, 19, 5, "cpu"))


def _headline_qps():
    """Condensed T=20 QPs of the first rows of the headline generator."""
    state, course, oa, od = (a[:B_SMALL] for a in chip_smoke.bench_inputs(chip_smoke.SEED))
    T, N = chip_smoke.T, chip_smoke.N
    cfg = MPCConfig(T=T)

    def t(a, dtype=F64):
        return torch.tensor(a, dtype=dtype)

    states, courses = t(state), t(course)
    speeds = torch.zeros((B_SMALL, N), dtype=F64)
    valid = torch.full((B_SMALL,), N, dtype=torch.int32)
    dls = torch.full((B_SMALL,), chip_smoke.DL, dtype=F64)
    cs = init_controller_state(cfg, device="cpu", batch=B_SMALL)
    ref = compute_reference(states, courses, speeds, valid, dls, cs.target_idx,
                            cs.ov.to(F64), cs.have_ov, T, cfg.dt)
    qp = build_qp_reference(*chip_smoke.k1_inputs((states, courses, speeds, valid, dls),
                                                  t(oa), t(od), ref, cfg))
    return qp.P, qp.q, qp.G, qp.lo, qp.hi


QPS = {"random_T5": _random_qps, "headline_T20": _headline_qps}


def _active_set(kind, qp):
    """(act_lo, act_hi) of a = 0, a = 1, the ADMM duals' set or a = m."""
    P, q, G, lo, hi = qp
    sol = ruiz_admm_batched(*qp, **chip_smoke.solver_kw(MPCConfig(T=20)))
    y = sol.y
    if kind == "none":
        off = torch.zeros_like(y, dtype=torch.bool)
        return off, off
    if kind == "one":
        row = y.abs().argmax(1, keepdim=True)
        one = torch.zeros_like(y, dtype=torch.bool).scatter_(1, row, True)
        return one & (y < 0), one & (y >= 0)
    if kind == "admm":
        tol = ACT_TOL_REL * y.abs().amax(1, keepdim=True).clamp(min=1.0)
        return y < -tol, y > tol
    gx = (G @ sol.x[..., None])[..., 0]
    near_lo = gx - lo <= hi - gx
    return near_lo, ~near_lo


def _compact_polish(P, q, G, lo, hi, act_lo, act_hi, Lp, H):
    """The polish on the active rows only, scenario by scenario, from the
    factors of ``_polish_factor`` (Lp = chol(P), H = G P^-1 G'). Returns x,
    y and each scenario's condition number of S_aa + ridge (1 at a = 0)."""
    xs, ys, kappa = [], [], []
    for b in range(q.shape[0]):
        idx = torch.nonzero(act_lo[b] | act_hi[b]).flatten()  # ascending
        a = idx.numel()
        Ga = G[b, idx]
        ba = torch.where(act_lo[b, idx], lo[b, idx], hi[b, idx])
        S = H[b][idx][:, idx]
        dmax = float(S.diagonal().max()) if a else -np.inf
        S = S + 1e-7 * max(dmax, 1.0) * torch.eye(a, dtype=F64)
        Ls = torch.linalg.cholesky(S)
        kappa.append(float(torch.linalg.cond(S)) if a else 1.0)

        def kkt_solve(r1, r2):
            pir = torch.cholesky_solve(r1[:, None], Lp[b])[:, 0]
            dl = torch.cholesky_solve((Ga @ pir - r2)[:, None], Ls)[:, 0]
            return pir - torch.cholesky_solve((Ga.T @ dl)[:, None], Lp[b])[:, 0], dl

        x, lam = kkt_solve(-q[b], ba)
        dx, dl = kkt_solve(-(q[b] + P[b] @ x + Ga.T @ lam), ba - Ga @ x)
        y = torch.zeros(G.shape[1], dtype=F64)
        y[idx] = lam + dl
        xs.append(x + dx)
        ys.append(y)
    return torch.stack(xs), torch.stack(ys), torch.tensor(kappa, dtype=F64)


def _assert_close(got, want, kappa, what):
    scale = want.abs().amax(1).clamp(min=1.0)
    err = (got - want).abs().amax(1) / scale
    bar = torch.clamp(4 * kappa * torch.finfo(F64).eps, min=1e-10)
    worst = int((err / bar).argmax())
    assert bool((err <= bar).all()), (
        f"{what}: scenario {worst} relative error {float(err[worst]):.3g} > {float(bar[worst]):.3g}")


@pytest.mark.parametrize("qps", sorted(QPS))
@pytest.mark.parametrize("kind", ["none", "one", "admm", "all"])
def test_active_row_polish_equals_the_masked_full_polish(qps, kind):
    qp = QPS[qps]()
    act_lo, act_hi = _active_set(kind, qp)
    a = (act_lo | act_hi).sum(1)
    m = qp[2].shape[1]
    want_a = {"none": 0, "one": 1, "all": m}.get(kind)
    if want_a is None:
        assert bool(((a > 0) & (a < m)).all()), a
    else:
        assert bool((a == want_a).all()), a
    Lp, H = _polish_factor(qp[0], qp[2])
    x, y, kappa = _compact_polish(*qp, act_lo, act_hi, Lp, H)
    assert bool((y[~(act_lo | act_hi)] == 0).all())
    xp, yp = _polish_masks(*qp, act_lo, act_hi, Lp, H)
    _assert_close(x, xp, kappa, "x vs the port's _polish_masks")
    _assert_close(y, yp, kappa, "y vs the port's _polish_masks")

    j = tuple(jnp.asarray(t.numpy()) for t in qp)
    fac = jax.vmap(jax_polish_factor)(j[0], j[1], j[2])
    xj, yj = jax.vmap(jax_polish_masks)(*j, jnp.asarray(act_lo.numpy()),
                                        jnp.asarray(act_hi.numpy()), fac)
    _assert_close(x, torch.from_numpy(np.array(xj)), kappa, "x vs the JAX _polish_masks")
    _assert_close(y, torch.from_numpy(np.array(yj)), kappa, "y vs the JAX _polish_masks")
    if kind == "none":
        _assert_close(x, -torch.cholesky_solve(qp[1][..., None], Lp)[..., 0], kappa,
                      "x vs -P^-1 q")
