"""PyTorch port, K2 at a long horizon: where its float32 tail comes from.

On warm ``MPCConfig(T=40, dt=0.1)`` ticks some rows of K2's solution end far
from the float64 optimum. ``chip_smoke.py --tail-sample`` builds the QPs of
such a tick on the CPU (``chip_smoke.tail_qps``: the headline generator's
first 1024 rows after five closed-loop ticks of the plain path, then the
next tick's QP and warm start) and holds K2 on the card, the plain solver on
the card and on the CPU to the float64 optimum (``chip_smoke.true_solution``);
it keeps the 32 rows where K2 ends farthest from it and 32 others
(``KEPT``). Here the same rows are built on the CPU and solved, warm-started
as the tick does, by the JAX package's fused Pallas kernel in interpret
mode (``solve_box_qp_lanes(fused=True, interpret=True)``, the algorithm K2
ports, with its explicit L^-1 and M^-1 = Y'Y), by the JAX XLA batched
solver and by the port's plain solver, each held to the float64 optimum:
max|x - x*| over the rows the optimum certifies, at the quantiles the card
run measured for K2 (``BARS``). The JAX kernel's tail is as heavy as K2's
on these rows, so K2's is the reference algorithm's float32 behaviour, not a
fault of the port (``ROADMAP.md`` §3, decided mismatches).

Run as a script with the file ``chip_smoke.py --tail-sample`` wrote on the
card (the package's ``_build/tail_sample.npz``, copied here) to print each
solver's quantiles on the card's rows beside K2's:

    JAX_PLATFORMS=cpu python tests/test_torch_admm_tail.py tail_sample.npz
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpc_for_av_at_intersection_tpu.mpc.qp import solve_box_qp_batched as jax_solve_batched
from mpc_for_av_at_intersection_tpu.mpc.qp import solve_box_qp_lanes
from mpc_for_av_at_intersection_tpu.ops.admm_pallas import LANES
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched

import chip_smoke

torch.set_num_threads(2)

# the rows ``chip_smoke.py --tail-sample`` kept (NVIDIA H100 80GB HBM3,
# 700.00 W): K2's 32 farthest from the float64 optimum, then 32 spread
# over the certified rows
KEPT = (777, 385, 888, 62, 208, 162, 602, 240, 282, 535, 412, 370, 540, 264, 617, 731, 595, 278,
        305, 827, 142, 880, 211, 819, 646, 576, 528, 373, 432, 301, 816, 626, 0, 32, 66, 97, 131,
        164, 195, 228, 261, 297, 330, 363, 399, 431, 463, 494, 526, 560, 592, 627, 660, 692, 724,
        756, 789, 823, 856, 889, 923, 955, 988, 1023)
QUANTILES = (0.5, 0.9, 1.0)
# p50/p90/max of max|x - x*| on these rows built on the CPU, as this file's
# test measured them
# (rounded up in the third digit)
BARS = {"x": {"jax_pallas_interpret": (1.24, 1.68, 2.22), "jax_xla": (1.24, 1.68, 2.22),
              "port_plain": (1.24, 1.68, 2.22)},
        "controls": {"jax_pallas_interpret": (6.9e-4, 0.0128, 0.0400),
                     "jax_xla": (8.5e-4, 0.0127, 0.0400), "port_plain": (7.1e-4, 0.0128, 0.0400)}}


def _lanes(a):
    """(B, ...) -> the Pallas lanes layout (1, ..., 128), B <= 128 rows
    padded with copies of the first."""
    a = np.concatenate([a, np.repeat(a[:1], LANES - a.shape[0], 0)])
    return jnp.moveaxis(jnp.asarray(a, jnp.float32).reshape((1, LANES) + a.shape[1:]), 1, -1)


def solve_all(qp, warm):
    """x of the JAX fused Pallas kernel (interpret mode), the JAX XLA
    solver and the port's plain solver on the float32 QPs ``qp`` (numpy),
    warm-started from ``warm``, under the T=40 controller's schedule."""
    kw = chip_smoke.solver_kw(MPCConfig(T=chip_smoke.LONG_T, dt=chip_smoke.LONG_DT))
    B = qp[0].shape[0]
    pad = [np.concatenate([a, np.repeat(a[:1], LANES - B, 0)]) for a in warm]
    ref = solve_box_qp_lanes(*(_lanes(a) for a in qp), B0=LANES, fused=True, interpret=True,
                             warm=tuple(jnp.asarray(a, jnp.float32) for a in pad), **kw)
    xla = jax_solve_batched(*(jnp.asarray(a, jnp.float32) for a in qp), use_pallas=False,
                            warm=tuple(jnp.asarray(a, jnp.float32) for a in warm), **kw)
    port = solve_box_qp_batched(*(torch.as_tensor(a) for a in qp),
                                warm=tuple(torch.as_tensor(a) for a in warm), **kw)
    return {"jax_pallas_interpret": np.asarray(ref.x)[:B], "jax_xla": np.asarray(xla.x),
            "port_plain": port.x.numpy()}


def errors(xs, qp, cols=slice(None)):
    """{solver: its quantiles of max|x - x*| (over the columns ``cols``: all,
    or the first step's two controls) over the certified rows}, the float64
    optimum x* from ``chip_smoke.true_solution``."""
    x_true, cert = chip_smoke.true_solution(tuple(torch.as_tensor(a) for a in qp))
    cert = cert.numpy()
    out = {}
    for name, x in xs.items():
        e = np.abs(x.astype(np.float64) - x_true.numpy())[:, cols].max(1)[cert]
        out[name] = [float(np.quantile(e, p)) for p in QUANTILES]
    return out, int(cert.sum())


@pytest.fixture(scope="module")
def sample():
    """The KEPT rows' warm T=40 QPs built here (float32 numpy) and the
    three solvers' x on them."""
    qp, warm = chip_smoke.tail_qps(list(KEPT))
    qp, warm = tuple(a.numpy() for a in qp), tuple(a.numpy() for a in warm)
    return qp, solve_all(qp, warm)


@pytest.mark.parametrize("cols", ["x", "controls"])
def test_the_jax_kernel_and_the_plain_solver_share_k2s_tail_at_T40(sample, cols):
    """max|x - x*| (all of x, or the first step's two controls) over the
    certified rows, at p50/p90/max, within the bars measured on these rows
    (``BARS``); the JAX fused kernel's and the port's plain solver's largest
    within 1.5x of each other, as K2's and the JAX kernel's were on the
    card's rows (2.213 against 2.213 over x, 0.02556 against 0.02581 over
    the controls; ``main``)."""
    qp, xs = sample
    out, n_cert = errors(xs, qp, slice(None) if cols == "x" else slice(0, 2))
    assert n_cert >= 60
    for name, q in out.items():
        for p, got, bar in zip(QUANTILES, q, BARS[cols][name]):
            assert got <= bar, (cols, name, p, got, bar)
    jx, pp = out["jax_pallas_interpret"][-1], out["port_plain"][-1]
    assert jx <= 1.5 * pp and pp <= 1.5 * jx, (cols, jx, pp)


def main(path):
    """Each solver's quantiles on the card run's rows (``path``, written by
    ``chip_smoke.py --tail-sample``), K2's and the card's plain solver's
    beside them, against the float64 optimum recomputed here."""
    d = np.load(path)
    qp = tuple(d[k] for k in ("P", "q", "G", "lo", "hi"))
    xs = solve_all(qp, tuple(d[k] for k in ("x0", "y0", "rho0")))
    xs.update(k2_card=d["x_k2"], plain_card=d["x_plain_card"], plain_cpu_card=d["x_plain_cpu"])
    for rows, tag in ((slice(0, 32), "K2's 32 farthest rows"), (slice(None), "all 64 rows")):
        sub = tuple(a[rows] for a in qp)
        for cols, what in ((slice(None), "x"), (slice(0, 2), "the first controls")):
            out, n_cert = errors({k: v[rows] for k, v in xs.items()}, sub, cols)
            print(f"{tag} ({n_cert} certified), max|x - x*| over {what}, p50/p90/max:")
            for name, q in out.items():
                print(f"  {name:22s} " + " ".join(f"{v:.4g}" for v in q))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1])
