"""PyTorch port: the single-scenario controller and closed loop against the JAX package.

- ``bicycle_step``/``bicycle_rollout``, ``arc_positions``,
  ``transform_points_xy``/``transform_poses`` on the same numpy inputs:
  1e-12 in float64, 1e-6 in float32 (sines, cosines and tangents come from
  two libraries).
- ``mpc_step`` (one scenario: ``mpc_step_batched`` at B=1) against the JAX
  ``mpc_step`` (the XLA ``solve_box_qp``), and ``mpc_step_jerk`` against
  the JAX ``mpc_step_jerk`` at ``admm_eps=0``, on 8 courses of
  ``tests/test_torch_mpc_step.py``'s generator over two ticks, the second
  from the JAX first tick's state; bars of that file's ``_compare``
  (target_idx and solved exact, accel/steer 2e-4 where both sides'
  polish accepted, 2e-2 elsewhere).
- ``engine_tick`` on the flagship (``api.build_intersection``) tick by tick
  from the JAX states, through the conflict cutoff to the goal: x within
  2e-4, steer within 5e-4, and done, collision_found, cutoff_len, solved,
  agent_idx and ticks_to_goal exact (the bars of
  ``tests/test_torch_fleet.py``'s tick-by-tick test).
- ``run_episode`` against the JAX ``run_episode`` at 150 ticks
  (``tests/test_engine.py:N_STEPS``), free running in float32: done and
  ticks_to_goal equal, x within 2e-4 over every tick.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu.core import curves as jcurves
from mpc_for_av_at_intersection_tpu.core import dynamics as jdynamics
from mpc_for_av_at_intersection_tpu.core import transforms as jtransforms
from mpc_for_av_at_intersection_tpu.engine import closed_loop as jloop
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc import controller as jcontroller
from mpc_for_av_at_intersection_tpu.mpc import init_controller_state as jax_init_state
from mpc_for_av_at_intersection_tpu.mpc import jerk as jjerk
from mpc_for_av_at_intersection_tpu_torch.core import (
    arc_positions,
    bicycle_rollout,
    bicycle_step,
    transform_points_xy,
    transform_poses,
)
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    engine_state_from_numpy,
    engine_tick,
    run_episode,
    world_from_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_stack
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import (
    MPCConfig,
    controller_state_from_numpy,
    init_controller_state,
    mpc_step,
)
from mpc_for_av_at_intersection_tpu_torch.mpc import batch as port_batch
from mpc_for_av_at_intersection_tpu_torch.mpc.jerk import mpc_step_jerk

from test_torch_mpc_step import _compare, _scenarios

torch.set_num_threads(2)

GEOM = bicycle_geometry()
WHEELBASE = GEOM.wheelbase
N_STEPS = 150


def _np(tree):
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


# ----------------------------------------------------------------- core --

@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_bicycle_arc_and_transforms_match_jax(dtype, tol):
    rng = np.random.default_rng(4)
    pose = np.stack([rng.uniform(-20, 20, 64), rng.uniform(-20, 20, 64),
                     rng.uniform(-np.pi, np.pi, 64)], -1).astype(dtype)
    v = rng.uniform(0, 9, 64).astype(dtype)
    delta = rng.uniform(-0.6, 0.6, 64).astype(dtype)

    def close(got, want, scale=1.0):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol * scale)

    close(bicycle_step(torch.tensor(pose), torch.tensor(v), torch.tensor(delta), 0.1, WHEELBASE),
          jdynamics.bicycle_step(jnp.asarray(pose), jnp.asarray(v), jnp.asarray(delta), 0.1,
                                 WHEELBASE))
    # the primitive generator's call: one pose, constant speed and steer
    got = bicycle_rollout(torch.zeros(3, dtype=torch.from_numpy(pose).dtype), 8.3, 0.3, 0.01,
                          WHEELBASE, 60)
    want = jdynamics.bicycle_rollout(jnp.zeros(3, dtype), 8.3, 0.3, 0.01, WHEELBASE, 60)
    assert got.shape == (61, 3)
    close(got, want, 10.0)
    got = bicycle_rollout(torch.tensor(pose), torch.tensor(v), torch.tensor(delta), 0.1,
                          WHEELBASE, 25)
    want = jdynamics.bicycle_rollout(jnp.asarray(pose), jnp.asarray(v), jnp.asarray(delta), 0.1,
                                     WHEELBASE, 25)
    assert got.shape == (26, 64, 3)
    close(got, want, 10.0)

    # curves of 300 points, a padded tail masked off
    yaw = rng.uniform(-np.pi, np.pi, (8, 1)) + rng.normal(0, 0.05, (8, 300)).cumsum(1)
    xy = (np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], -1) * 0.083, 1)).astype(dtype)
    valid = np.arange(300)[None, :] < rng.integers(2, 301, (8, 1))
    want = jax.vmap(jcurves.arc_positions)(jnp.asarray(xy), jnp.asarray(valid))
    close(arc_positions(torch.tensor(xy), torch.tensor(valid)), want, 30.0)
    close(arc_positions(torch.tensor(xy[0])), jcurves.arc_positions(jnp.asarray(xy[0])), 30.0)

    local = np.concatenate([xy[:, :40], rng.uniform(-3, 3, (8, 40, 1)).astype(dtype)], -1)
    frames = pose[:8]
    close(transform_points_xy(torch.tensor(frames), torch.tensor(local[..., :2])),
          jtransforms.transform_points_xy(jnp.asarray(frames), jnp.asarray(local[..., :2])), 30.0)
    close(transform_poses(torch.tensor(frames), torch.tensor(local)),
          jtransforms.transform_poses(jnp.asarray(frames), jnp.asarray(local)), 30.0)
    # one frame broadcast over every curve
    close(transform_poses(torch.tensor(frames[0]), torch.tensor(local)),
          jtransforms.transform_poses(jnp.asarray(frames[0]), jnp.asarray(local)), 30.0)


# ----------------------------------------------------------- controller --

def _jax_ticks(args, cs, jcfg, module, fn, monkeypatch):
    """The JAX single-scenario tick over the rows of ``args`` (vmapped), and
    the polish flag of each row's QP solve."""
    solve = module.solve_box_qp

    def tick(state4, course, speed, valid, dl, c):
        seen = []

        def recording(*a, **k):
            sol = solve(*a, **k)
            seen.append(sol.polished)
            return sol

        monkeypatch.setattr(module, "solve_box_qp", recording)
        out = fn(state4, course, speed, valid, dl, c, jcfg, WHEELBASE)
        monkeypatch.setattr(module, "solve_box_qp", solve)
        return out, seen[-1]

    out, pol = jax.jit(jax.vmap(tick))(*(jnp.asarray(a) for a in args), cs)
    return out, np.asarray(pol)


def _port_ticks(args, cs_rows, cfg, fn, monkeypatch):
    """The port's single-scenario tick row by row, stacked, and each row's
    polish flag."""
    seen = []
    solve = port_batch.solve_box_qp

    def recording(*a, **k):
        sol = solve(*a, **k)
        seen.append(bool(sol.polished[0]))
        return sol

    monkeypatch.setattr(port_batch, "solve_box_qp", recording)
    outs = []
    for b, cs in enumerate(cs_rows):
        row = [torch.tensor(a[b]) for a in args]
        out = fn(*row, cs, cfg, WHEELBASE)
        assert out.accel.shape == () and out.plan_xy.shape == (cfg.T + 1, 2)
        assert out.state.qp_x.shape == (cfg.qp_dims[0],)
        outs.append(out)
    monkeypatch.setattr(port_batch, "solve_box_qp", solve)
    return tree_stack(outs), np.asarray(seen)


def _rows(cs_np, B):
    return [controller_state_from_numpy({k: v[b] for k, v in cs_np.items()}, device="cpu")
            for b in range(B)]


@pytest.mark.parametrize("variant", ["canonical", "jerk"])
def test_mpc_step_matches_jax_over_two_ticks(variant, monkeypatch):
    if variant == "jerk":
        jcfg = dataclasses.replace(JaxMPCConfig.with_jerk(), admm_eps=0.0)
        cfg = dataclasses.replace(MPCConfig.with_jerk(), admm_eps=0.0)
        module, jfn, fn = jjerk, jjerk.mpc_step_jerk, mpc_step_jerk
    else:
        jcfg, cfg = JaxMPCConfig(), MPCConfig()
        module, jfn, fn = jcontroller, jcontroller.mpc_step, mpc_step
    assert cfg.jerk == (variant == "jerk")
    B = 8
    args = _scenarios(B=B, seed=7)
    cs_j = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                        jax_init_state(jcfg, jnp.float32))
    cs_rows = [init_controller_state(cfg, device="cpu") for _ in range(B)]
    limits = jdynamics.SimLimits(max_steer=jcfg.max_steer, max_speed=jcfg.max_speed,
                                 min_speed=jcfg.min_speed)
    for tick in (1, 2):
        ref, ref_pol = _jax_ticks(args, cs_j, jcfg, module, jfn, monkeypatch)
        got, got_pol = _port_ticks(args, cs_rows, cfg, fn, monkeypatch)
        _compare(got, got_pol, ref, ref_pol, tick)
        assert got.state.qp_x.shape == (B, cfg.qp_dims[0])
        np.testing.assert_array_equal(got.xref.numpy(), np.asarray(ref.xref))
        cs_j = ref.state
        cs_rows = _rows(_np(cs_j), B)
        st = jax.vmap(lambda s, a, d: jdynamics.plant_step(
            s, jnp.stack([a, d]), jcfg.dt, WHEELBASE, limits))(jnp.asarray(args[0]), ref.accel,
                                                               ref.steer)
        args = (np.asarray(st, np.float32),) + args[1:]
    # the dispatch: mpc_step of a jerk config is mpc_step_jerk
    if variant == "jerk":
        row = [torch.tensor(a[0]) for a in args]
        a, b = mpc_step(*row, cs_rows[0], cfg, WHEELBASE), fn(*row, cs_rows[0], cfg, WHEELBASE)
        torch.testing.assert_close(a.accel, b.accel, rtol=0, atol=0)
        with pytest.raises(ValueError, match="jerk"):
            mpc_step_jerk(*row, init_controller_state(MPCConfig(), device="cpu"), MPCConfig(),
                          WHEELBASE)


# --------------------------------------------------------------- engine --

@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship driver, its states tick by tick and its scanned
    episode."""
    setup = japi.build_intersection(n_steps=N_STEPS)
    cfg, geom = setup.cfg, setup.geom
    tick = jax.jit(lambda w, s: jloop.engine_tick(w, s, cfg, geom))
    states, tels = [setup.state0], []
    for _ in range(N_STEPS):
        st, tel = tick(setup.world, states[-1])
        states.append(st)
        tels.append(tel)
    final, tel_scan = jax.jit(lambda w, s: jloop.run_episode(w, s, cfg, geom, N_STEPS))(
        setup.world, setup.state0)
    return setup, states, tels, final, tel_scan


def test_engine_tick_matches_jax_tick_by_tick(flagship):
    setup, states, tels, _, _ = flagship
    cfg = EngineConfig()
    world = world_from_numpy(_np(setup.world), device="cpu")
    last = int(np.asarray(states[-1].ticks_to_goal)) + 3
    assert last < N_STEPS
    n_cut = 0
    for k in range(last):
        st = engine_state_from_numpy(_np(states[k]), device="cpu")
        new, tel = engine_tick(world, st, cfg, GEOM)
        want, wtel = states[k + 1], tels[k]
        assert tel.x.shape == () and new.ego.shape == (4,)
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4, rtol=0,
                                   err_msg=f"tick {k}")
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(wtel, name)), err_msg=f"tick {k} {name}")
        for name in ("agent_idx", "cutoff_len", "done", "ticks_to_goal", "tick", "first_tick"):
            np.testing.assert_array_equal(getattr(new, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=f"tick {k} {name}")
        np.testing.assert_allclose(new.agents.pose.numpy(), np.asarray(want.agents.pose),
                                   atol=1e-9, rtol=0)
        n_cut += int(tel.cutoff_len < world.n_course)
    assert n_cut > 0   # the conflict cutoff took part
    assert bool(new.done)   # and the scenario finished, frozen since


def test_run_episode_matches_jax(flagship):
    setup, states, _, jfinal, jtel = flagship
    cfg = EngineConfig()
    world = world_from_numpy(_np(setup.world), device="cpu")
    st0 = engine_state_from_numpy(_np(states[0]), device="cpu")
    assert world.course.dtype == torch.float32
    final, tel = run_episode(world, st0, cfg, GEOM, N_STEPS)
    assert tel.x.shape == (N_STEPS,) and tel.collision_xy.shape == (N_STEPS, 2)
    assert bool(final.done) and bool(np.asarray(jfinal.done))
    assert int(final.ticks_to_goal) == int(np.asarray(jfinal.ticks_to_goal))
    np.testing.assert_array_equal(tel.done.numpy(), np.asarray(jtel.done))
    np.testing.assert_allclose(tel.x.numpy(), np.asarray(jtel.x), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tel.y.numpy(), np.asarray(jtel.y), atol=2e-4, rtol=0)
    assert bool(tel.solved.all()) and int(tel.collision_found.sum()) > 0
