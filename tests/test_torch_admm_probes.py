"""PyTorch port, the profile path's ADMM probes (``ops/admm_probes.py``).

Each plain probe (what its wrapper runs on CPU tensors) is held to the JAX
package's Pallas probe in interpret mode, on the same numpy float32 inputs,
cold (x = z = y = 0) and warm (from the JAX cold run's x, z, y):

- on the random box-QPs of ``tests/test_torch_admm.py`` (B=128, n=6, m=9,
  rho = 0.1), Probe-3 with M^-1 = (P + sigma I + rho G'G)^-1 from float64;
- on one bench-shaped instance: T=5 (n=10, m=19), condensed by the port and
  scaled by ``_ruiz_equilibrate`` with its default 10 passes, as the
  profiler scales it.

Bars (float32, the same recurrences with sums in another order):

- Probe-3 and Probe-1 (one round at a fixed rho): every output within
  1e-4 x max(1, max|JAX output|) on every row. Observed ~3e-5 relative
  after 170 iterations.
- Probe-2 (three rounds with the OSQP rho rule between them): the rule
  multiplies rho by up to ~100 a round on rows whose box-QP is infeasible
  (max|Gx - z| stays ~1), where y grows with rho and two float32 runs
  part. So: the rows that converge (JAX prim and dual <= 1e-3) are the
  same on both sides up to 2 of 128, and on the rows converged on both z,
  y, prim and dual are within the Probe-3 bar (observed <= 5e-5
  relative) and x within 1e-3 x max(1, max|x|): after 510 iterations the
  warm bench instance's x differs by up to 1e-4 relative at residuals of
  1e-6, along the condensed Hessian's near-flat directions (its condition
  number grows with T; ~1e7 at T=20). On the other rows prim, which the
  rule does not amplify, is within 1e-2 x max(1, prim) (observed < 4e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.ops.admm_pallas import (
    admm_all_rounds_pallas,
    admm_iterations_pallas,
    admm_round_full_pallas,
)
from mpc_for_av_at_intersection_tpu_torch import ops
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import _ruiz_equilibrate, scale_qp
from mpc_for_av_at_intersection_tpu_torch.ops.admm_probes import (
    admm_all_rounds,
    admm_all_rounds_reference,
    admm_iterations,
    admm_iterations_reference,
    admm_round_full,
    admm_round_full_reference,
)

from test_torch_admm import _mpc_instances, _random_batch

torch.set_num_threads(2)

CFG = MPCConfig()
ITERS, ROUNDS = CFG.admm_iters, CFG.admm_rounds       # 170, 3
SIGMA, ALPHA, RHO = CFG.admm_sigma, CFG.admm_alpha, CFG.admm_rho
BAR = 1e-4


def _scaled(qp):
    """Ruiz-scale (P, q, G, lo, hi) as bench_profile does."""
    P, q, G, lo, hi = (torch.as_tensor(np.asarray(a, np.float32)) for a in qp)
    return tuple(a.numpy() for a in scale_qp(P, q, G, lo, hi, *_ruiz_equilibrate(P, q, G)))


@pytest.fixture(scope="module", params=["random", "bench_T5"])
def problem(request):
    """(P, q, G, lo, hi) float32 numpy, B=128."""
    if request.param == "random":
        return _random_batch(np.random.default_rng(1), 128, 6, 9)
    qp = _scaled(_mpc_instances(5, 128, seed=11))
    assert qp[0].shape == (128, 10, 10) and qp[2].shape == (128, 19, 10)
    return qp


def _start(problem, warm_from=None):
    P, q, G, lo, hi = problem
    B, n = q.shape
    m = lo.shape[1]
    if warm_from is None:
        return np.zeros((B, n), np.float32), np.zeros((B, m), np.float32), np.zeros((B, m), np.float32)
    return tuple(np.asarray(a, np.float32) for a in warm_from[:3])


def _flat(out):
    return [v for e in out for v in (e if isinstance(e, tuple) else (e,))]


def _jax(fn, *args, **kw):
    return _flat(fn(*(jnp.asarray(a, jnp.float32) for a in args), interpret=True, **kw))


def _port(fn, *args, **kw):
    return [t.numpy() for t in _flat(fn(*(torch.tensor(a) for a in args), **kw))]


def _assert_close(got, ref, rows=slice(None), what="", x_bar=BAR):
    for k, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        bar = x_bar if k == 0 else BAR
        scale = max(1.0, float(np.abs(r[rows]).max(initial=0.0)))
        err = float(np.abs(g[rows] - r[rows]).max(initial=0.0))
        assert err <= bar * scale, f"{what} output {k}: {err} > {bar} x {scale}"


@pytest.mark.parametrize("warm", [False, True])
def test_admm_iterations_matches_pallas(problem, warm):
    P, q, G, lo, hi = problem
    B, n = q.shape
    rho = np.full(B, RHO, np.float32)
    M = P.astype(np.float64) + SIGMA * np.eye(n) + RHO * np.einsum("bri,brj->bij", G, G)
    Minv = np.linalg.inv(M).astype(np.float32)
    kw = dict(iters=ITERS, sigma=SIGMA, alpha=ALPHA)
    start = _start(problem)
    if warm:
        start = _start(problem, _jax(admm_iterations_pallas, Minv, G, q, lo, hi, rho, *start, **kw))
    args = (Minv, G, q, lo, hi, rho) + start
    _assert_close(_port(admm_iterations_reference, *args, **kw),
                  _jax(admm_iterations_pallas, *args, **kw), what="Probe-3")


@pytest.mark.parametrize("warm", [False, True])
def test_admm_round_full_matches_pallas(problem, warm):
    P, q, G, lo, hi = problem
    rho = np.full(q.shape[0], RHO, np.float32)
    kw = dict(iters=ITERS, sigma=SIGMA, alpha=ALPHA)
    start = _start(problem)
    if warm:
        start = _start(problem, _jax(admm_round_full_pallas, P, G, q, lo, hi, rho, *start, **kw))
    args = (P, G, q, lo, hi, rho) + start
    got = _port(admm_round_full_reference, *args, **kw)
    assert len(got) == 9          # x, z, y, prim, dual and the four scales
    _assert_close(got, _jax(admm_round_full_pallas, *args, **kw), what="Probe-1")


@pytest.mark.parametrize("warm", [False, True])
def test_admm_all_rounds_matches_pallas(problem, warm):
    P, q, G, lo, hi = problem
    rho = np.full(q.shape[0], RHO, np.float32)
    kw = dict(rounds=ROUNDS, iters=ITERS, sigma=SIGMA, alpha=ALPHA)
    start = _start(problem)
    if warm:
        start = _start(problem, _jax(admm_all_rounds_pallas, P, G, q, lo, hi, rho, *start, **kw))
    args = (P, G, q, lo, hi, rho) + start
    got = _port(admm_all_rounds_reference, *args, **kw)
    ref = _jax(admm_all_rounds_pallas, *args, **kw)
    conv_ref = (ref[3] <= 1e-3) & (ref[4] <= 1e-3)
    conv_got = (got[3] <= 1e-3) & (got[4] <= 1e-3)
    assert int((conv_ref != conv_got).sum()) <= 2
    assert int(conv_ref.sum()) >= len(conv_ref) // 2
    both = conv_ref & conv_got
    _assert_close(got, ref, rows=both, what="Probe-2 converged rows", x_bar=1e-3)
    rest = ~both
    prim_err = np.abs(got[3] - ref[3])[rest]
    assert bool((prim_err <= 1e-2 * np.maximum(1.0, ref[3][rest])).all()), prim_err.max(initial=0)


def test_round_full_is_all_rounds_at_one_round():
    """Probe-1 and Probe-2 at rounds=1 run the same arithmetic."""
    P, q, G, lo, hi = (torch.as_tensor(a) for a in _random_batch(np.random.default_rng(2), 7, 6, 9))
    rho = torch.full((7,), RHO)
    start = (torch.zeros(7, 6), torch.zeros(7, 9), torch.zeros(7, 9))
    one = admm_round_full(P, G, q, lo, hi, rho, *start, ITERS, SIGMA, ALPHA)
    allr = admm_all_rounds(P, G, q, lo, hi, rho, *start, 1, ITERS, SIGMA, ALPHA)
    for a, b in zip(one[:5], allr):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    zero = admm_all_rounds(P, G, q, lo, hi, rho, *start, 0, ITERS, SIGMA, ALPHA)
    assert all(bool((t == 0).all()) for t in zero)


def test_wrappers_on_cpu_run_the_plain_versions_in_the_input_dtype():
    P, q, G, lo, hi = (torch.as_tensor(a).double()
                       for a in _random_batch(np.random.default_rng(3), 5, 6, 9))
    rho = torch.full((5,), RHO, dtype=torch.float64)
    start = (torch.zeros(5, 6, dtype=torch.float64), torch.zeros(5, 9, dtype=torch.float64),
             torch.zeros(5, 9, dtype=torch.float64))
    before = (admm_iterations.launches, admm_round_full.launches, admm_all_rounds.launches)
    Minv = torch.linalg.inv(P + RHO * G.transpose(1, 2) @ G)
    cases = ((ops.admm_iterations, admm_iterations_reference, (Minv,), (ITERS,)),
             (admm_round_full, admm_round_full_reference, (P,), (ITERS,)),
             (admm_all_rounds, admm_all_rounds_reference, (P,), (ROUNDS, ITERS)))
    for wrapper, plain, first, counts in cases:
        args = first + (G, q, lo, hi, rho) + start + counts + (SIGMA, ALPHA)
        got, want = _flat(wrapper(*args)), _flat(plain(*args))
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (admm_iterations.launches, admm_round_full.launches,
            admm_all_rounds.launches) == before == (0, 0, 0)
