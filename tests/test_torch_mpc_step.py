"""PyTorch port, the slice: the batched controller tick ``mpc_step_batched``.

The port's tick (on CPU tensors: the plain versions of K1 and K2) is held to
the JAX package's ``mpc_step_batched(use_pallas=False)`` with the default
adaptive, warm-started ``MPCConfig`` at T=13 and T=20, B=16, N=200, on the
course generator of ``tests/test_batched_solver.py:96-116``. Two ticks: the
port's second tick starts from the JAX first tick's controller state
(through ``controller_state_from_numpy``) and plant state, so each tick is
compared on equal inputs.

Bars: ``target_idx`` exact, ``solved`` equal, accel/steer within 2e-4 where
both sides' QP polish accepted (``tests/test_batched_solver.py:122-123``).
A row where the polish decision differs, or where neither side polished,
returns a raw ADMM iterate on at least one side; such a row is held to the
loose bar of ``tests/test_batched_solver.py:361-362`` (2e-2) instead.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpc_for_av_at_intersection_tpu.core.dynamics import SimLimits as JaxSimLimits
from mpc_for_av_at_intersection_tpu.core.dynamics import plant_step as jax_plant_step
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc import batch as jax_batch
from mpc_for_av_at_intersection_tpu.mpc import init_controller_state as jax_init_state
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import (
    MPCConfig,
    controller_state_from_numpy,
    controller_state_to_numpy,
    init_controller_state,
)
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import _mpc_step, mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.ops.admm import solve_box_qp_fused
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp

from test_torch_condense_qp import _courses

torch.set_num_threads(2)

F32 = jnp.float32
WHEELBASE = bicycle_geometry().wheelbase
TIGHT, LOOSE = 2e-4, 2e-2


def _scenarios(B=16, N=200, seed=3):
    rng = np.random.default_rng(seed)
    course = _courses(rng, B, N)
    i0 = rng.integers(3, 30, size=B)
    states = np.stack([course[np.arange(B), i0, 0], course[np.arange(B), i0, 1],
                       rng.uniform(0, 8, B), course[np.arange(B), i0, 2]],
                      axis=1).astype(np.float32)
    return (states, course, np.zeros((B, N), np.float32), np.full((B,), N, np.int32),
            np.full((B,), 0.083, np.float32))


def _jax_tick(args, cs, cfg, monkeypatch):
    """The JAX tick, and the polish flags of the QP solve inside it."""
    seen = []
    solve = jax_batch.solve_box_qp_batched

    def recording(*a, **k):
        sol = solve(*a, **k)
        seen.append(np.asarray(sol.polished))
        return sol

    monkeypatch.setattr(jax_batch, "solve_box_qp_batched", recording)
    out = jax_batch.mpc_step_batched(*(jnp.asarray(a) for a in args), cs, cfg, WHEELBASE,
                                     use_pallas=False)
    monkeypatch.setattr(jax_batch, "solve_box_qp_batched", solve)
    return out, seen[-1]


def _port_tick(args, cs, cfg):
    seen = []

    def recording(*a, **k):
        sol = solve_box_qp_fused(*a, **k)
        seen.append(sol.polished.numpy())
        return sol

    out = _mpc_step(*(torch.as_tensor(a) for a in args), cs, cfg, WHEELBASE, build_qp, recording)
    return out, seen[-1]


def _compare(port, port_pol, ref, ref_pol, tick):
    np.testing.assert_array_equal(port.target_idx.numpy(), np.asarray(ref.target_idx))
    solved = np.asarray(ref.solved)
    np.testing.assert_array_equal(port.solved.numpy(), solved)
    assert solved.sum() >= len(solved) - 1, f"tick {tick}: {solved.sum()} solved"
    tight = port_pol & ref_pol & solved
    assert tight.sum() >= len(solved) // 2, f"tick {tick}: only {tight.sum()} rows polished by both"
    for name in ("accel", "steer"):
        d = np.abs(getattr(port, name).numpy() - np.asarray(getattr(ref, name)))
        assert d[tight].max(initial=0.0) <= TIGHT, f"tick {tick} {name}: {d[tight].max()}"
        # rows with a raw ADMM iterate on at least one side: the loose bar
        assert d[solved].max(initial=0.0) <= LOOSE, f"tick {tick} {name}: {d[solved].max()}"


@pytest.mark.parametrize("T", [13, 20])
def test_mpc_step_batched_matches_jax_over_two_ticks(T, monkeypatch):
    jcfg, cfg = JaxMPCConfig(T=T), MPCConfig(T=T)
    assert jcfg.warm_start_qp and jcfg.admm_eps > 0
    args = _scenarios()
    B = args[0].shape[0]

    cs_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jax_init_state(jcfg, F32))
    ref1, ref1_pol = _jax_tick(args, cs_j, jcfg, monkeypatch)
    out1, out1_pol = _port_tick(args, init_controller_state(cfg, batch=B), cfg)
    _compare(out1, out1_pol, ref1, ref1_pol, 1)
    assert bool(np.asarray(ref1.state.have_qp).all())

    # tick 2 on equal inputs: the JAX tick-1 state and the plant moved by
    # the JAX tick-1 controls
    limits = JaxSimLimits(max_steer=jcfg.max_steer, max_speed=jcfg.max_speed,
                          min_speed=jcfg.min_speed)
    states2 = np.asarray(jax.vmap(lambda s, a, d: jax_plant_step(
        s, jnp.stack([a, d]), jcfg.dt, WHEELBASE, limits))(
        jnp.asarray(args[0]), ref1.accel, ref1.steer), np.float32)
    args2 = (states2,) + args[1:]
    ref2, ref2_pol = _jax_tick(args2, ref1.state, jcfg, monkeypatch)
    cs2 = controller_state_from_numpy(
        {k: np.asarray(v) for k, v in ref1.state._asdict().items()})
    assert cs2.target_idx.dtype == torch.int32 and cs2.have_qp.dtype == torch.bool
    out2, out2_pol = _port_tick(args2, cs2, cfg)
    _compare(out2, out2_pol, ref2, ref2_pol, 2)
    np.testing.assert_allclose(out2.plan_xy.numpy(), np.asarray(ref2.plan_xy), atol=5e-2)
    np.testing.assert_array_equal(out2.xref.numpy(), np.asarray(ref2.xref))


def test_public_tick_is_the_kernel_path_and_state_round_trips():
    cfg = MPCConfig(T=13)
    args = tuple(torch.as_tensor(a) for a in _scenarios(B=4))
    cs = init_controller_state(cfg, batch=4)
    out = mpc_step_batched(*args, cs, cfg, WHEELBASE)
    again, _ = _port_tick(tuple(a.numpy() for a in args), cs, cfg)
    for a, b in zip(out, again):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    back = controller_state_from_numpy(controller_state_to_numpy(out.state))
    for name, a in out.state._asdict().items():
        b = getattr(back, name)
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jerk_config_is_not_ported_yet():
    cfg = MPCConfig.with_jerk()
    args = tuple(torch.as_tensor(a) for a in _scenarios(B=2))
    with pytest.raises(NotImplementedError):
        mpc_step_batched(*args, init_controller_state(cfg, batch=2), cfg, WHEELBASE)
