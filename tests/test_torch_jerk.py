"""PyTorch port: the jerk (comfort) controller variant against the JAX package.

- ``linearize_bicycle(nx=5)`` and ``condense_jerk`` against the JAX XLA
  functions in float64 on the same operating points: every field within
  1e-10 * max(1, |ref|max) (same formulas; only the order of the sums in
  the batched products differs).
- ``build_qp_reference`` in the jerk mode (rollout -> nx=5 linearization ->
  ``condense_jerk``) against the JAX Pallas kernel ``build_qp_pallas`` with
  the jerk config in interpret mode, at T=13 and T=20, with the bar of
  ``tests/test_torch_condense_qp.py``: 2e-6 * max(1, |ref|max) per field.
- The jerk tick (plain versions on CPU tensors) against the JAX
  ``mpc_step_batched`` (XLA) under the fixed budget (``admm_eps=0``), over
  two ticks, the second from the JAX state (warm x of width 2T+1) carried
  in through ``controller_state_from_numpy``: accel and steer within 5e-4,
  ``target_idx`` exact (``tests/test_batched_solver.py:174-177``).
- The fleet engine under ``EngineConfig(mpc=MPCConfig.with_jerk())``
  against the JAX ``engine_tick_fleet(use_pallas=False)``, tick by tick from
  the carried JAX state, with the bars of ``tests/test_fleet_engine.py``:
  x atol 2e-4, steer atol 5e-4, ``done``, ``solved``, ``agent_idx``,
  ``cutoff_len`` and ``collision_found`` exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu.core.dynamics import SimLimits as JaxSimLimits
from mpc_for_av_at_intersection_tpu.core.dynamics import plant_step as jax_plant_step
from mpc_for_av_at_intersection_tpu.engine import EngineConfig as JaxEngineConfig
from mpc_for_av_at_intersection_tpu.engine import fleet as jfleet
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc import init_controller_state as jax_init_state
from mpc_for_av_at_intersection_tpu.mpc.batch import mpc_step_batched as jax_mpc_step_batched
from mpc_for_av_at_intersection_tpu.mpc.jerk import condense_jerk as jax_condense_jerk
from mpc_for_av_at_intersection_tpu.mpc.linearize import linearize_bicycle as jax_linearize
from mpc_for_av_at_intersection_tpu.ops.condense_pallas import build_qp_pallas
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    engine_state_from_numpy,
    engine_tick_fleet,
    world_from_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import (
    MPCConfig,
    controller_state_from_numpy,
    init_controller_state,
)
from mpc_for_av_at_intersection_tpu_torch.mpc.batch import mpc_step_batched
from mpc_for_av_at_intersection_tpu_torch.mpc.condense import CondensedQP
from mpc_for_av_at_intersection_tpu_torch.mpc.jerk import condense_jerk
from mpc_for_av_at_intersection_tpu_torch.mpc.linearize import linearize_bicycle
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

from test_torch_condense_qp import _assert_fields_match, _instances
from test_torch_mpc_step import _scenarios

torch.set_num_threads(2)

F32 = jnp.float32
GEOM = bicycle_geometry()
WHEELBASE = GEOM.wheelbase


def _jerk_cfgs(T, **kw):
    return (dataclasses.replace(JaxMPCConfig.with_jerk(), T=T, **kw),
            dataclasses.replace(MPCConfig.with_jerk(), T=T, **kw))


@pytest.mark.parametrize("T", [13, 20])
def test_linearize_and_condense_jerk_match_jax_f64(T):
    jcfg, cfg = _jerk_cfgs(T)
    rng = np.random.default_rng(40 + T)
    B = 12
    vbar = rng.uniform(0, 8, (B, T))
    phibar = rng.uniform(-np.pi, np.pi, (B, T))
    deltabar = rng.uniform(-0.3, 0.3, (B, T))
    x0 = rng.normal(0, 3, (B, 4))
    xref = rng.normal(0, 3, (B, 4, T + 1))
    re = rng.random((B, T + 1)) < 0.3
    lin = [jax.vmap(lambda v, p, d: jax_linearize(v, p, d, jcfg.dt, WHEELBASE, nx=5))(
        *(jnp.asarray(a) for a in (vbar, phibar, deltabar)))]
    got_lin = linearize_bicycle(*(torch.as_tensor(a) for a in (vbar, phibar, deltabar)),
                                cfg.dt, WHEELBASE, nx=5)
    for a, b in zip(got_lin, lin[0]):
        assert a.shape == b.shape and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    A, Bm, C = (np.array(a) for a in lin[0])
    ref = jax.vmap(lambda a, b, c, s, r, e: jax_condense_jerk(a, b, c, s, r, e, jcfg))(
        *(jnp.asarray(a) for a in (A, Bm, C, x0, xref, re)))
    got = condense_jerk(*(torch.as_tensor(a) for a in (A, Bm, C, x0, xref, re)), cfg)
    assert got.P.shape == (B, 2 * T + 1, 2 * T + 1) and got.F.shape == (B, 5 * T, 2 * T + 1)
    for name in CondensedQP._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-10 * max(1.0, float(np.abs(a).max())),
                                   err_msg=name)
    assert re[:, 1:].any()   # the terminal (5x5 Qf) blocks took part


@pytest.mark.parametrize("T", [13, 20])
def test_build_qp_reference_jerk_matches_pallas_interpret(T):
    jcfg, cfg = _jerk_cfgs(T)
    inst = _instances(T, seed=7)
    states, oa, od, xref = (jnp.asarray(a, F32) for a in inst[:4])
    ref = build_qp_pallas(states, oa, od, xref, jnp.asarray(inst[4]), jcfg, WHEELBASE,
                          interpret=True)
    got = build_qp_reference(*(torch.as_tensor(a) for a in inst), cfg, WHEELBASE)
    assert got.q.shape[1] == 2 * T + 1 and got.g.shape[1] == 5 * T
    _assert_fields_match(got, ref)


def test_build_qp_on_cpu_runs_the_plain_jerk_version():
    inst = _instances(13, B=6, seed=2)
    args = tuple(torch.as_tensor(a) for a in inst)
    cfg = MPCConfig.with_jerk()
    before = build_qp.launches
    got = build_qp(*args, cfg, WHEELBASE)
    want = build_qp_reference(*args, cfg, WHEELBASE)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert build_qp.launches == before


def test_jerk_tick_matches_jax_over_two_ticks():
    jcfg, cfg = _jerk_cfgs(13, admm_eps=0.0)
    args = _scenarios(B=16, seed=5)
    B = args[0].shape[0]
    cs_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jax_init_state(jcfg, F32))
    cs = init_controller_state(cfg, device="cpu", batch=B)
    assert cs.qp_x.shape == (B, 2 * cfg.T + 1) == cs_j.qp_x.shape

    for tick in range(2):
        ref = jax_mpc_step_batched(*(jnp.asarray(a) for a in args), cs_j, jcfg, WHEELBASE,
                                   use_pallas=False)
        got = mpc_step_batched(*(torch.as_tensor(a) for a in args), cs, cfg, WHEELBASE)
        np.testing.assert_array_equal(got.target_idx.numpy(), np.asarray(ref.target_idx))
        np.testing.assert_array_equal(got.solved.numpy(), np.asarray(ref.solved))
        assert bool(got.solved.all()), tick
        np.testing.assert_allclose(got.accel.numpy(), np.asarray(ref.accel), atol=5e-4)
        np.testing.assert_allclose(got.steer.numpy(), np.asarray(ref.steer), atol=5e-4)
        assert got.state.qp_x.shape == (B, 2 * cfg.T + 1)
        assert got.plan_xy.shape == (B, cfg.T + 1, 2)
        # the next tick starts from the JAX state, the plant moved as JAX moved it
        cs_j = ref.state
        cs = controller_state_from_numpy({k: np.asarray(v) for k, v in cs_j._asdict().items()},
                                         device="cpu")
        limits = JaxSimLimits(max_steer=jcfg.max_steer, max_speed=jcfg.max_speed,
                              min_speed=jcfg.min_speed)
        st = jax.vmap(lambda s, a, d: jax_plant_step(s, jnp.stack([a, d]), jcfg.dt, WHEELBASE,
                                                     limits))(jnp.asarray(args[0]), ref.accel,
                                                              ref.steer)
        args = (np.asarray(st, np.float32),) + args[1:]


def _np(tree):
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def test_jerk_fleet_matches_jax_tick_by_tick():
    jcfg = JaxEngineConfig(mpc=JaxMPCConfig.with_jerk())
    cfg = EngineConfig(mpc=MPCConfig.with_jerk())
    kw = dict(n_steps=20, planner="host", starts=(1, 4), turns=(1, 2))
    geom, jw, js, _ = japi.sample_intersection_fleet_batched(6, np.random.default_rng(9), jcfg, **kw)
    _, pw, ps, _ = api.sample_intersection_fleet_batched(6, np.random.default_rng(9), cfg,
                                                         device="cpu", **kw)
    assert ps.ctrl.qp_x.shape == (6, 2 * cfg.mpc.T + 1) == js.ctrl.qp_x.shape
    tick = jax.jit(lambda w, s: jfleet.engine_tick_fleet(w, s, jcfg, geom, use_pallas=False))
    world = world_from_numpy(_np(jw), device="cpu")
    for k in range(6):
        st = engine_state_from_numpy(_np(js), device="cpu")
        new, tel = engine_tick_fleet(world, st, cfg, GEOM)
        js, wtel = tick(jw, js)
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0)
        np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4, rtol=0)
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(wtel, name)), err_msg=f"{k} {name}")
        np.testing.assert_array_equal(new.agent_idx.numpy(), np.asarray(js.agent_idx))
        assert new.ctrl.qp_x.shape == (6, 2 * cfg.mpc.T + 1)
    assert bool(np.asarray(wtel.solved).all())
