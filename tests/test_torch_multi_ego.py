"""PyTorch port: the multi-ego engine against the JAX package's, and its three ticks
against each other.

- ``multi_ego_tick`` (each ego's subtick on its own) on the two-ego
  crossing of ``tests/test_multi_ego.py:39`` tick by tick from the JAX
  states, through the egos' conflict: the bars of
  ``tests/test_torch_fleet.py``'s tick-by-tick test (x 2e-4, steer 5e-4;
  done, collision_found, cutoff_len, solved, agent_idx, ticks_to_goal
  exact) and the peers' predictions (QUIRKS #5) through the conflict flags.
- ``multi_ego_tick_batched`` against ``multi_ego_tick`` over 12 ticks, and
  ``multi_ego_fleet_tick`` against the batched tick over 6 ticks, in the
  port: the bars of ``tests/test_multi_ego.py:87,123`` (egos 2e-4, accel
  2e-3, done exact). The fleet runs S=3 junctions, a prime (the JAX
  package's ``best_pre_chunk`` fell to chunks of one there; the port has no
  chunking), each a different pair of egos, so a row that lands in another
  junction shows.
- ``multi_ego_fleet_tick`` at S=3 tick by tick from the JAX states, 14
  ticks into every junction's conflict, against the JAX fleet tick with its pre stage chunked (``pre_chunk_egos``
  = 2: ``best_pre_chunk`` gives chunks of one junction at a prime S) and
  unchunked, with the fleet bars above: the port leaves the chunking out,
  and equals both.
- ``run_multi_ego_episode`` picks the per-ego tick below 8 egos and the
  batched one from 8, and stacks telemetry (n_steps, E).
"""

import numpy as np
import pytest
import torch

import jax

from mpc_for_av_at_intersection_tpu.agents import stack_agents as jstack_agents
from mpc_for_av_at_intersection_tpu.engine import EngineConfig as JaxEngineConfig
from mpc_for_av_at_intersection_tpu.engine import multi_ego as jmulti
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.agents import stack_agents
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    MultiEgoState,
    MultiEgoWorld,
    engine_state_from_numpy,
    init_multi_ego_state,
    make_multi_ego_world,
    multi_ego_fleet_tick,
    multi_ego_tick,
    multi_ego_tick_batched,
    run_multi_ego_episode,
    world_from_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.engine import multi_ego
from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_stack
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

torch.set_num_threads(2)

GEOM = bicycle_geometry()
PAIRS = [((1, 2), (4, 1)), ((2, 1), (3, 2)), ((4, 3), (1, 1))]   # (start_pos, turn) per ego


@pytest.fixture(scope="module")
def courses():
    """The host search's courses of every ego of PAIRS."""
    keys = sorted({k for pair in PAIRS for k in pair})
    return {k: api.plan_course(intersection(turn_indicator=k[1], start_pos=k[0]), GEOM,
                               use_native=True) for k in keys}


def _np(tree):
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _world_from_jax(w) -> MultiEgoWorld:
    d = _np(w)
    return MultiEgoWorld(*world_from_numpy(
        {"course": d["courses"], "n_course": d["n_courses"], "dl": d["dls"],
         "goal_xy": d["goals_xy"], "agent_params": d["agent_params"]}, device="cpu"))


def _state_from_jax(s) -> MultiEgoState:
    d = _np(s)
    names = dict(egos="ego", ctrls="ctrl", cutoff_lens="cutoff_len", agent_idxs="agent_idx")
    return MultiEgoState(*engine_state_from_numpy({names.get(k, k): v for k, v in d.items()},
                                                  device="cpu"))


def _junction(courses, pair, n_steps=12, cfg=None):
    cfg = cfg or EngineConfig()
    params, ag = stack_agents([], n_slots=cfg.n_agents)
    world = make_multi_ego_world([courses[k] for k in pair], params, cfg, device="cpu")
    return world, init_multi_ego_state(world, ag, cfg, n_steps, device="cpu")


def test_multi_ego_tick_matches_jax_tick_by_tick(courses):
    trajs = [courses[k] for k in PAIRS[0]]
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    params, ag = jstack_agents([], n_slots=jcfg.n_agents)
    jw = jmulti.make_multi_ego_world(trajs, params, jcfg)
    js = jmulti.init_multi_ego_state(jw, ag, jcfg, 180)
    tick = jax.jit(lambda s: jmulti.multi_ego_tick(jw, s, jcfg, GEOM))
    world = _world_from_jax(jw)
    # the port's own builders give the same world and state
    pw, ps = _junction(courses, PAIRS[0], 180)
    for a, b in zip(jax.tree.leaves(tuple(world)), jax.tree.leaves(tuple(pw))):
        np.testing.assert_array_equal(b.numpy(), a.numpy().astype(b.numpy().dtype))
    for a, b in zip(jax.tree.leaves(tuple(_state_from_jax(js))), jax.tree.leaves(tuple(ps))):
        np.testing.assert_array_equal(b.numpy(), a.numpy().astype(b.numpy().dtype))

    n_conflict = 0
    for k in range(70):
        st = _state_from_jax(js)
        new, tel = multi_ego_tick(world, st, cfg, GEOM)
        js, wtel = tick(js)
        assert tel.x.shape == (2,) and new.egos.shape == (2, 4) and new.first_tick.shape == ()
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0,
                                   err_msg=f"tick {k}")
        np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4, rtol=0,
                                   err_msg=f"tick {k}")
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(wtel, name)), err_msg=f"tick {k} {name}")
        for name in ("agent_idxs", "cutoff_lens", "done", "ticks_to_goal", "tick", "first_tick"):
            np.testing.assert_array_equal(getattr(new, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=f"tick {k} {name}")
        n_conflict += int(tel.collision_found.sum())
    assert n_conflict > 0                 # the egos saw each other
    assert bool(np.asarray(js.done).any())   # and one of them finished, frozen since


def test_batched_tick_matches_per_ego_tick(courses):
    cfg = EngineConfig()
    world, st_a = _junction(courses, PAIRS[0])
    st_b = st_a
    for k in range(12):
        st_a, tel_a = multi_ego_tick(world, st_a, cfg, GEOM)
        st_b, tel_b = multi_ego_tick_batched(world, st_b, cfg, GEOM)
        assert tel_b.accel.shape == (2,) and st_b.tick.shape == ()
        np.testing.assert_allclose(st_b.egos.numpy(), st_a.egos.numpy(), atol=2e-4, err_msg=str(k))
        np.testing.assert_array_equal(st_b.done.numpy(), st_a.done.numpy())
        np.testing.assert_allclose(tel_b.accel.numpy(), tel_a.accel.numpy(), atol=2e-3)
        assert not bool(st_b.first_tick)


def test_fleet_tick_of_a_prime_number_of_junctions_matches_batched_ticks(courses):
    cfg = EngineConfig()
    junctions = [_junction(courses, pair) for pair in PAIRS]
    worldS = tree_stack([w for w, _ in junctions])
    stS = tree_stack([s for _, s in junctions])
    assert stS.egos.shape == (3, 2, 4) and stS.first_tick.shape == (3,)
    states = [s for _, s in junctions]
    for k in range(6):
        stS, telS = multi_ego_fleet_tick(worldS, stS, cfg, GEOM)
        assert telS.accel.shape == (3, 2) and telS.collision_xy.shape == (3, 2, 2)
        for j, (w, _) in enumerate(junctions):
            states[j], tel1 = multi_ego_tick_batched(w, states[j], cfg, GEOM)
            np.testing.assert_allclose(stS.egos[j].numpy(), states[j].egos.numpy(), atol=2e-4,
                                       err_msg=f"tick {k} junction {j}")
            np.testing.assert_allclose(telS.accel[j].numpy(), tel1.accel.numpy(), atol=2e-3)
            np.testing.assert_array_equal(stS.done[j].numpy(), states[j].done.numpy())
            np.testing.assert_array_equal(stS.cutoff_lens[j].numpy(), states[j].cutoff_lens.numpy())
            np.testing.assert_array_equal(stS.tick[j].numpy(), states[j].tick.numpy())
    # the three junctions moved apart
    assert float((stS.egos[0] - stS.egos[1]).abs().max()) > 1.0
    # use_kernels=False takes the plain versions wherever the tensors are:
    # on the CPU the same arithmetic
    a, _ = multi_ego_fleet_tick(worldS, stS, cfg, GEOM, use_kernels=False)
    b, _ = multi_ego_fleet_tick(worldS, stS, cfg, GEOM)
    torch.testing.assert_close(a.egos, b.egos, rtol=0, atol=0)


def test_fleet_tick_matches_the_jax_fleet_tick_chunked_and_unchunked(courses):
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    params, ag = jstack_agents([], n_slots=jcfg.n_agents)
    junctions = [jmulti.make_multi_ego_world([courses[k] for k in pair], params, jcfg)
                 for pair in PAIRS]
    jw = jax.tree.map(lambda *a: jax.numpy.stack(a), *junctions)
    js = jax.tree.map(lambda *a: jax.numpy.stack(a),
                      *(jmulti.init_multi_ego_state(w, ag, jcfg, 12) for w in junctions))
    ticks = {chunk: jax.jit(lambda w, s, c=chunk: jmulti.multi_ego_fleet_tick(
        w, s, jcfg, GEOM, use_pallas=False, pre_chunk_egos=c)) for chunk in (2, 0)}
    world = _world_from_jax(jw)
    assert world.courses.shape[:2] == (3, 2)
    n_conflict = 0
    for k in range(14):
        st = _state_from_jax(js)
        new, tel = multi_ego_fleet_tick(world, st, cfg, GEOM)
        for chunk, tick in ticks.items():
            want, wtel = tick(jw, js)
            msg = f"tick {k}, pre_chunk_egos={chunk}"
            np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0,
                                       err_msg=msg)
            np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4,
                                       rtol=0, err_msg=msg)
            for name in ("done", "collision_found", "cutoff_len", "solved"):
                np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                              np.asarray(getattr(wtel, name)), err_msg=msg)
            for name in ("agent_idxs", "cutoff_lens", "done", "tick", "first_tick"):
                np.testing.assert_array_equal(getattr(new, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=msg)
        js = want
        n_conflict += int(tel.collision_found.sum())
    assert n_conflict > 0


def test_run_multi_ego_episode_picks_its_tick(courses, monkeypatch):
    cfg = EngineConfig()
    world, st0 = _junction(courses, PAIRS[0], 4)
    calls = []
    for name in ("multi_ego_tick", "multi_ego_tick_batched"):
        fn = getattr(multi_ego, name)
        monkeypatch.setattr(multi_ego, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    final, tel = run_multi_ego_episode(world, st0, cfg, GEOM, 4)
    assert calls == ["multi_ego_tick"] * 4
    assert tel.x.shape == (4, 2) and tel.collision_xy.shape == (4, 2, 2)
    assert int(final.tick) == 4
    calls.clear()
    final_b, _ = run_multi_ego_episode(world, st0, cfg, GEOM, 4, batched=True)
    assert calls == ["multi_ego_tick_batched"] * 4
    np.testing.assert_allclose(final_b.egos.numpy(), final.egos.numpy(), atol=2e-4)
