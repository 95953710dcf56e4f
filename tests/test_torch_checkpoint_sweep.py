"""PyTorch port: checkpoint / resume and the sensitivity sweeps against the JAX package.

- ``save_state``/``load_state`` round trip the flagship's state exactly,
  with the JAX package's file layout: the ``__treedef__`` string equals
  JAX's for the same state, a snapshot written by the JAX ``save_state``
  loads into the port equal to the port's own ``state0``, and a state with
  a ``None`` leaf or a snapshot of another leaf count is refused.
- A 40-tick JAX episode equals JAX's first 20 ticks, saved by JAX, loaded
  by the port and continued 20 ticks there: done and ticks_to_goal equal,
  the ego within 2e-4 (the bars of ``tests/test_torch_episode.py``).
- ``run_chunked`` broken off and resumed from its file equals the straight
  run bit for bit (the same ticks on the same tensors).
- ``planner_weight_sweep`` (host code) gives the JAX sweep's costs and
  expansions exactly; ``mpc_weight_sweep`` gives JAX's ticks-to-goal
  exactly and its max deviation within 1e-4, on 24-tick episodes of the
  flagship without traffic. Free running to the goal (tick 49) the two
  packages separate by centimetres in the turn, where the steering at top
  speed is weakly determined by the QP (from tick ~22 on, at every weight),
  so the parity is held on the approach; ``tests/test_torch_cli.py`` runs
  the port's sweep to the goal.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu import sweep as jsweep
from mpc_for_av_at_intersection_tpu.engine import run_episode as jax_run_episode
from mpc_for_av_at_intersection_tpu.lattice import SearchWeights as JaxSearchWeights
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.utils import checkpoint as jcheckpoint
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu_torch import api, sweep
from mpc_for_av_at_intersection_tpu_torch.engine import run_episode
from mpc_for_av_at_intersection_tpu_torch.lattice import SearchWeights
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc.controller import init_controller_state
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
from mpc_for_av_at_intersection_tpu_torch.utils.checkpoint import (
    _leaves,
    _treedef,
    load_state,
    run_chunked,
    save_state,
)
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

torch.set_num_threads(2)


@pytest.fixture
def jax_python_planner(monkeypatch):
    """The JAX drivers plan with the Python search (the JAX package's native
    build races under xdist; the port's native core is bit-equal to it)."""
    monkeypatch.setattr(japi, "plan_course", functools.partial(japi.plan_course,
                                                               use_native=False))


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    setup = api.build_intersection(other_vehicles=False, n_steps=64, device="cpu")
    p = tmp_path / "state.npz"
    save_state(p, setup.state0)
    _assert_states_equal(setup.state0, load_state(p, setup.state0))
    assert not (tmp_path / "state.tmp.npz").exists()


def test_jax_snapshot_loads_into_the_port(tmp_path, jax_python_planner):
    want = japi.build_intersection(other_vehicles=False, n_steps=64).state0
    p = tmp_path / "jax_state.npz"
    jcheckpoint.save_state(p, want)
    ours = api.build_intersection(other_vehicles=False, n_steps=64, device="cpu").state0
    assert f"PyTreeDef({_treedef(ours)})" == str(jax.tree_util.tree_structure(want))
    _assert_states_equal(ours, load_state(p, ours))
    # and the port's snapshot loads into the JAX package
    q = tmp_path / "port_state.npz"
    save_state(q, ours)
    back = jcheckpoint.load_state(q, want)
    for x, y in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_refuses_none_leaves_and_other_leaf_counts(tmp_path):
    setup = api.build_intersection(other_vehicles=False, n_steps=64, device="cpu")
    with pytest.raises(ValueError, match="None"):
        save_state(tmp_path / "none.npz", setup.state0._replace(tick=None))
    p = tmp_path / "ctrl.npz"
    save_state(p, init_controller_state(MPCConfig(), device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        load_state(p, setup.state0)


def test_jax_episode_continues_in_the_port(tmp_path, jax_python_planner):
    setup = japi.build_intersection(n_steps=64)
    run = jax.jit(lambda s, n: jax_run_episode(setup.world, s, setup.cfg, setup.geom, n),
                  static_argnums=1)
    final_40, tel_40 = run(setup.state0, 40)
    mid, _ = run(setup.state0, 20)
    p = tmp_path / "mid.npz"
    jcheckpoint.save_state(p, mid)

    ours = api.build_intersection(n_steps=64, device="cpu")
    st = load_state(p, ours.state0)
    assert int(st.tick) == 20
    final, tel = run_episode(ours.world, st, ours.cfg, ours.geom, 20)
    assert int(final.tick) == 40
    assert bool(final.done) == bool(final_40.done)
    assert int(final.ticks_to_goal) == int(final_40.ticks_to_goal)
    np.testing.assert_allclose(final.ego.numpy(), np.asarray(final_40.ego), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tel.x.numpy(), np.asarray(tel_40.x)[20:], atol=2e-4, rtol=0)
    np.testing.assert_allclose(tel.y.numpy(), np.asarray(tel_40.y)[20:], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tel.collision_found.numpy(),
                                  np.asarray(tel_40.collision_found)[20:])


def test_run_chunked_resume_matches_straight_run(tmp_path):
    setup = api.build_intersection(other_vehicles=False, n_steps=64, device="cpu")

    def step_many(s, n):
        return run_episode(setup.world, s, setup.cfg, setup.geom, n)

    final_a, _ = step_many(setup.state0, 60)
    ck = str(tmp_path / "ck.npz")
    state_mid, tels = run_chunked(step_many, setup.state0, 40, 20, ckpt_path=ck)
    assert int(state_mid.tick) == 40 and len(tels) == 2
    assert isinstance(tels[0].x, np.ndarray) and tels[0].x.shape == (20,)
    # a fresh start from the checkpoint: only the last 20 ticks run
    final_b, tels_b = run_chunked(step_many, setup.state0, 60, 20, ckpt_path=ck)
    assert len(tels_b) == 1 and int(final_b.tick) == 60
    _assert_states_equal(final_a, final_b)


def test_planner_weight_sweep_matches_jax():
    grid = {"h_dist": [1.0, 2.0]}
    want = jsweep.planner_weight_sweep(jax_intersection(turn_indicator=1, start_pos=4),
                                       jax_geometry(), weight_grid=grid,
                                       base=JaxSearchWeights.modified())
    got = sweep.planner_weight_sweep(intersection(turn_indicator=1, start_pos=4),
                                     bicycle_geometry(), weight_grid=grid,
                                     base=SearchWeights.modified())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.weights == w.weights
        assert g.cost == w.cost and g.n_expanded == w.n_expanded and g.path_len == w.path_len
        np.testing.assert_array_equal(g.trajectory, w.trajectory)
    assert got[1].n_expanded <= got[0].n_expanded


def test_mpc_weight_sweep_matches_jax(jax_python_planner):
    n = 24
    values = [1.0, 5.0, 20.0]
    want = jsweep.mpc_weight_sweep(
        lambda cfg: japi.build_intersection(other_vehicles=False, cfg=cfg, n_steps=n),
        "w_perp", values, n_steps=n)
    got = sweep.mpc_weight_sweep(
        lambda cfg: api.build_intersection(other_vehicles=False, cfg=cfg, n_steps=n,
                                           device="cpu"),
        "w_perp", values, n_steps=n)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.param, g.value, g.done, g.ticks_to_goal) == (w.param, w.value, w.done,
                                                              w.ticks_to_goal)
        assert abs(g.max_deviation - w.max_deviation) <= 1e-4
        assert abs(g.mean_abs_accel - w.mean_abs_accel) <= 1e-4
        assert isinstance(g.telemetry.x, np.ndarray) and g.telemetry.x.shape == (n,)
    # stronger perpendicular weight -> tighter tracking
    assert got[2].max_deviation <= got[1].max_deviation <= got[0].max_deviation
