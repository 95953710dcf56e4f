"""PyTorch port: the scenario drivers of ``api.py`` against the JAX package's.

- Each builder's ``DriverSetup`` (basic-T over its nine canned setups, the
  multi-ego builder too) equals the JAX package's: the planned trajectory
  bit for bit (the port plans with its native C++ search, bit-equal to the
  Python search, which the JAX package is made to use here: its own native
  library is built with ``-march=native`` and differs in the last bits,
  ``tests/test_torch_native.py``), the config field for field, and every
  world and state0 array element-wise (the JAX arrays cast to the port's
  float32).
- The speed-reference driver (``EngineConfig.yield_by_speed``: the full
  path kept, the reference speed zeroed past the conflict) tick by tick
  from the JAX states over its first 60 ticks, which yield: done,
  collision_found, cutoff_len, solved, agent_idx and target_idx exact every
  tick, x within 2e-4. Where both sides' QP polish accepted, or both
  rejected it (both then return the same ADMM iterate), steer within 5e-4:
  the bars of ``tests/test_torch_fleet.py``'s tick-by-tick test. Where
  only one side polished (the JAX side rejects its polish at two of these
  ticks, 29 and 46, and returns an iterate 2e-5 outside a box and up to
  0.036 rad from the optimum), the polished side's first controls are held
  to the float64 optimum of the port's QP at 5e-4, and such ticks stay
  few.
- The outcome checks of ``tests/test_drivers.py`` on the port alone, on
  the CPU, for the speed-ref and multi-lane drivers
  (``test_torch_driver_outcomes.py`` holds the others).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu.engine import closed_loop as jloop
from mpc_for_av_at_intersection_tpu.mpc import controller as jcontroller
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.engine import (
    engine_state_from_numpy,
    engine_tick,
    run_episode,
    world_from_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.mpc import batch as port_batch
from mpc_for_av_at_intersection_tpu_torch.mpc.qp import solve_box_qp_batched

torch.set_num_threads(2)

N_STEPS = 200   # tests/test_drivers.py


def _np(tree):
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _assert_tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got._fields), path
        for k, v in want.items():
            _assert_tree_equal(v, getattr(got, k), f"{path}.{k}")
        return
    g = got.numpy()
    assert g.shape == want.shape, path
    np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=path)


BUILDERS = [("build_intersection", {}), ("build_roundabout", {}),
            ("build_roundabout", {"big": False, "turn_indicator": 1}),
            ("build_intersection_multi_lane", {}), ("build_intersection_speed_ref", {}),
            ("build_overtaking_cyclist", {}), ("build_multi_ego_intersection", {})] + [
    ("build_t_intersection_basic", {"scenario_no": k}) for k in range(1, 10)]


@pytest.mark.parametrize("name,kw", BUILDERS, ids=[
    f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for n, kw in BUILDERS])
def test_driver_setup_matches_jax(name, kw, monkeypatch):
    monkeypatch.setattr(japi, "plan_course", functools.partial(japi.plan_course, use_native=False))
    want = getattr(japi, name)(**kw)
    got = getattr(api, name)(device="cpu", **kw)
    np.testing.assert_array_equal(got.trajectory, want.trajectory)
    assert got.trajectory.dtype == want.trajectory.dtype
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert dataclasses.asdict(got.geom) == dataclasses.asdict(want.geom)
    assert type(got.scenario).__name__ == type(want.scenario).__name__
    _assert_tree_equal(_np(want.world), got.world, "world")
    _assert_tree_equal(_np(want.state0), got.state0, "state0")
    assert got.world.agent_params.speed.dtype == torch.float32
    if want.trajectories is not None:
        assert len(got.trajectories) == len(want.trajectories) == 2
        for a, b in zip(got.trajectories, want.trajectories):
            np.testing.assert_array_equal(a, b)


def _jax_tick_polished(cfg, geom):
    """The jitted JAX tick, with the polish flag of its QP solve."""
    solve = jcontroller.solve_box_qp

    def tick(w, s):
        seen = []

        def recording(*a, **k):
            sol = solve(*a, **k)
            seen.append(sol.polished)
            return sol

        jcontroller.solve_box_qp = recording
        try:
            out = jloop.engine_tick(w, s, cfg, geom)
        finally:
            jcontroller.solve_box_qp = solve
        return out, seen[-1]

    return jax.jit(tick)


def test_speed_ref_driver_matches_jax_tick_by_tick(monkeypatch):
    setup = japi.build_intersection_speed_ref()
    cfg, geom = setup.cfg, setup.geom
    assert cfg.yield_by_speed and cfg.mpc.speed_ref
    port_cfg = api.build_intersection_speed_ref(device="cpu").cfg
    tick = _jax_tick_polished(cfg, geom)
    world = world_from_numpy(_np(setup.world), device="cpu")

    seen = []
    solve = port_batch.solve_box_qp

    def recording(P, q, G, lo, hi, **kw):
        sol = solve(P, q, G, lo, hi, **kw)
        seen.append(((P, q, G, lo, hi), bool(sol.polished[0])))
        return sol

    monkeypatch.setattr(port_batch, "solve_box_qp", recording)
    js = setup.state0
    n_conflict, n_one_sided = 0, 0
    for k in range(60):
        st = engine_state_from_numpy(_np(js), device="cpu")
        new, tel = engine_tick(world, st, port_cfg, geom)
        (js, wtel), jpol = tick(setup.world, js)
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(wtel, name)), err_msg=f"tick {k} {name}")
        np.testing.assert_array_equal(new.agent_idx.numpy(), np.asarray(js.agent_idx))
        np.testing.assert_array_equal(new.ctrl.target_idx.numpy(), np.asarray(js.ctrl.target_idx))
        qp, pol = seen[-1]
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0,
                                   err_msg=f"tick {k}")
        if pol == bool(jpol):
            np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4,
                                       rtol=0, err_msg=f"tick {k}")
        else:
            # one side's raw ADMM iterate: the polished side's controls
            # against the float64 optimum of the QP
            n_one_sided += 1
            exact = solve_box_qp_batched(*(t.double() for t in qp), rounds=200, iters=50,
                                         eps=1e-10)
            assert bool(exact.polished[0])
            polished = new.ctrl if pol else js.ctrl
            for name, col in (("oa", 0), ("od", 1)):
                np.testing.assert_allclose(np.asarray(getattr(polished, name))[0],
                                           exact.x[0, col].numpy(), atol=5e-4, rtol=0,
                                           err_msg=f"tick {k} {name}, port polished: {pol}")
        n_conflict += int(tel.collision_found)
    # the speed channel yielded, and the one-sided ticks are rare
    assert n_conflict > 0
    assert n_one_sided <= 3


def _run(setup, n_steps=N_STEPS):
    return run_episode(setup.world, setup.state0, setup.cfg, setup.geom, n_steps)


def _check_finished(setup, final, tel, goal_tol=1.6):
    """tests/test_drivers.py::_check_finished."""
    assert bool(final.done), f"not done; end pos {final.ego[:2].tolist()}"
    k = int(final.ticks_to_goal)
    goal = setup.trajectory[-1, :2]
    assert np.hypot(float(tel.x[k - 1]) - goal[0], float(tel.y[k - 1]) - goal[1]) < goal_tol
    assert bool(tel.solved.all())
    assert float(tel.steer[:k].abs().max()) <= np.radians(45) + 1e-4


def test_speed_ref_driver_yields_and_finishes():
    setup = api.build_intersection_speed_ref(device="cpu")
    final, tel = _run(setup, 256)
    _check_finished(setup, final, tel)
    k = int(final.ticks_to_goal)
    # yielding happened through the speed channel: some conflict ticks exist
    assert bool(tel.collision_found[:k].any())


def test_multi_lane_driver():
    setup = api.build_intersection_multi_lane(number_of_lanes=2, device="cpu")
    final, tel = _run(setup)
    _check_finished(setup, final, tel)
    assert not bool(tel.collision_found.any())   # no traffic in this driver
