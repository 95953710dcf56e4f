"""PyTorch port: the fleet path against the JAX package.

- The pieces: scripted agents over all three policies, constant-control
  prediction, the conflict scan and the cutoff index, ``resample_mask`` and
  ``compact_by_mask``, the goal test and the deviation metric, on the same
  numpy inputs. Index outputs (keep masks, compacted rows, first hits,
  cutoff indices, goal flags) are exact; float outputs are held to a few
  ulps of their dtype (sines and cosines come from two libraries).
- The builder: ``sample_intersection_fleet_batched(16, planner="host",
  starts=(1, 4), turns=(1, 2))`` of both packages from the same seed gives
  element-wise equal arrays (the JAX arrays cast to the port's float32).
- The engine: 6 scenarios, 10 ticks of ``engine_tick_fleet`` from the
  carried JAX state, each tick on equal inputs, against the JAX package's
  ``engine_tick_fleet(use_pallas=False)``; then 10 free-running ticks
  against ``run_fleet_episodes(use_pallas=False)``. Bars of
  ``tests/test_fleet_engine.py:28-40``: x atol 2e-4, steer atol 5e-4,
  ``done`` exact; on equal inputs also ``agent_idx``, ``cutoff_len`` and
  ``collision_found`` exact.
- The conflict scan in slices of rows (``collision.SCAN_ELEMENTS`` set to
  a budget of 1-33 rows, and below one row) gives the whole scan's bits
  and JAX's results. ``engine_tick_fleet`` over 9 scenarios with the scan
  in slices of 1, 2 (the last one short) and 4 rows gives the unsliced
  tick's bits, tick by tick from the carried JAX state, and is held to
  the JAX package's ``engine_tick_fleet(use_pallas=False)`` with its pre
  stage chunked (``pre_chunk=2``) and whole by the bars above.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke

from mpc_for_av_at_intersection_tpu import agents as jagents
from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu.core import curves as jcurves
from mpc_for_av_at_intersection_tpu.engine import EngineConfig as JaxEngineConfig
from mpc_for_av_at_intersection_tpu.engine import fleet as jfleet
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc import controller as jcontroller
from mpc_for_av_at_intersection_tpu_torch import agents, api
from mpc_for_av_at_intersection_tpu_torch.core import compact_by_mask, resample_mask
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    Telemetry,
    engine_state_from_numpy,
    engine_state_to_numpy,
    engine_tick_fleet,
    run_fleet_episodes,
    world_from_numpy,
    world_to_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.agents import collision
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig, is_goal, xref_deviation
from mpc_for_av_at_intersection_tpu_torch.parallel import run_batch_episodes

torch.set_num_threads(2)

GEOM = bicycle_geometry()
DT = 0.2
N_TICKS, N_ROWS = 10, 6
SLICE_ROWS = 9                   # scenarios of the sliced-scan ticks


def _np(tree):
    """Nested dicts of numpy arrays from a JAX NamedTuple tree."""
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------- agents --

def _agent_rows(rng, B, n, dtype):
    policy = rng.integers(0, 3, (B, n)).astype(np.int32)
    params = dict(
        policy=policy,
        direction=rng.choice([-1.0, 1.0], (B, n)).astype(dtype),
        turning=rng.random((B, n)) < 0.6,
        speed=rng.uniform(3, 9, (B, n)).astype(dtype),
        offset=np.where(rng.random((B, n)) < 0.5, rng.uniform(0, 2, (B, n)), 0.0).astype(dtype),
        x_turn=rng.choice([-10.0, 12.0], (B, n)).astype(dtype),
        active=rng.random((B, n)) < 0.8,
    )
    # positions across the roundabout and T-junction zones, both half-planes
    pose = np.stack([rng.uniform(-12, 14, (B, n)), rng.uniform(-6, 6, (B, n)),
                     rng.uniform(-np.pi, 2 * np.pi, (B, n))], -1).astype(dtype)
    counter = rng.integers(0, 20, (B, n)).astype(np.int32)
    return params, pose, counter


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_agents_and_prediction_match_jax(dtype, tol):
    """The JAX side runs in float64 (its switch branches need one float
    type under x64) on the same values; the port in ``dtype``."""
    rng = np.random.default_rng(3)
    B, n = 64, 4
    params, pose, counter = _agent_rows(rng, B, n, dtype)

    def f64(v):
        return jnp.asarray(v.astype(np.float64) if v.dtype == dtype else v)

    jp = jagents.AgentParams(**{k: f64(v) for k, v in params.items()})
    js = jagents.AgentStates(pose=f64(pose), counter=jnp.asarray(counter))
    tp = agents.AgentParams(**{k: _t(v) for k, v in params.items()})
    ts = agents.AgentStates(pose=_t(pose), counter=_t(counter))

    want = np.asarray(jax.vmap(lambda p, s: jagents.agents_get(p, s, DT))(jp, js))
    got = agents.agents_get(tp, ts, DT)
    assert got.dtype == torch.float64 if dtype == np.float64 else torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)

    step = jax.vmap(lambda p, s: jagents.agents_step(p, s, DT, GEOM.wheelbase))(jp, js)
    got_step = agents.agents_step(tp, ts, DT, GEOM.wheelbase)
    np.testing.assert_allclose(got_step.pose.numpy(), np.asarray(step.pose), rtol=tol, atol=tol)
    np.testing.assert_array_equal(got_step.counter.numpy(), np.asarray(step.counter))

    n_pred = EngineConfig().n_pred
    want_pred = np.asarray(jagents.predict_constant_control(jnp.asarray(want), DT,
                                                            GEOM.wheelbase, n_pred))
    got_pred = agents.predict_constant_control(_t(want.astype(dtype)), DT, GEOM.wheelbase, n_pred)
    np.testing.assert_allclose(got_pred.numpy(), want_pred, rtol=tol * 10, atol=tol * 100)


# ----------------------------------------------------- curves + conflicts --

def _curves(rng, B, N, dl=0.083):
    yaw = rng.uniform(-np.pi, np.pi, (B, 1)) + rng.normal(0, 0.02, (B, N)).cumsum(1)
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], -1) * dl, 1) + rng.uniform(-20, 20, (B, 1, 2))
    return np.concatenate([xy, yaw[..., None]], -1).astype(np.float32)


def test_resample_and_compact_match_jax_exactly():
    rng = np.random.default_rng(11)
    B, N, out_len = 24, 1024, 128
    pts = _curves(rng, B, N)
    n_valid = rng.integers(2, N + 1, B)
    valid = np.arange(N)[None, :] < n_valid[:, None]
    v = rng.uniform(0, 8.4, (B, 1)).astype(np.float32)
    dl = (DT * np.minimum(v + 2.0 * (np.arange(N, dtype=np.float32) + 1.0), 30 / 3.6)).astype(np.float32)

    want = np.asarray(jax.vmap(lambda p, d, m: jcurves.resample_mask(p, d, m, keep_last=True))(
        jnp.asarray(pts), jnp.asarray(dl), jnp.asarray(valid)))
    got = resample_mask(_t(pts), _t(dl), _t(valid), keep_last=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # a scalar tick too, and keep_last off
    want2 = np.asarray(jax.vmap(lambda p, m: jcurves.resample_mask(p, 0.5, m, keep_last=False))(
        jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(resample_mask(_t(pts), 0.5, _t(valid), keep_last=False).numpy(),
                                  want2)

    # masks with more kept rows than the buffer holds, and an empty one
    mask = want.copy()
    mask[0] = valid[0]
    mask[1] = False
    w_out, w_n = jax.vmap(lambda p, m: jcurves.compact_by_mask(p, m, out_len))(
        jnp.asarray(pts), jnp.asarray(mask))
    g_out, g_n = compact_by_mask(_t(pts), _t(mask), out_len)
    np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(w_n))


def _conflict_inputs(rng, B, n_obs=4):
    cfg = EngineConfig()
    N, nF, n_pred = cfg.n_traj, cfg.n_frames, cfg.n_pred
    detail = _curves(rng, B, N, dl=0.083)
    detail[:, :, :2] -= detail[:, :1, :2]           # every path starts at the origin
    n_detail = rng.integers(100, N + 1, B).astype(np.int32)
    ego = detail[:, ::6][:, :nF].copy()
    n_ego = np.minimum(rng.integers(20, nF + 1, B), (n_detail + 5) // 6).astype(np.int32)
    # obstacles crossing the ego's path at a random point and speed
    k = rng.integers(10, 60, (B, n_obs))
    cross = detail[np.arange(B)[:, None], k * 3, :2]
    heading = rng.uniform(-np.pi, np.pi, (B, n_obs))
    speed = rng.uniform(1.0, 2.5, (B, n_obs))
    t = np.arange(n_pred) - k[..., None] / 2.0
    obs = np.stack([cross[..., 0:1] + np.cos(heading)[..., None] * speed[..., None] * t,
                    cross[..., 1:2] + np.sin(heading)[..., None] * speed[..., None] * t,
                    np.broadcast_to(heading[..., None], t.shape)], -1)
    active = rng.random((B, n_obs)) < 0.7
    return ego, n_ego, detail, n_detail, obs, active, cfg


def test_conflict_scan_and_cutoff_match_jax():
    rng = np.random.default_rng(5)
    B = 32
    ego, n_ego, detail, n_detail, obs, active, cfg = _conflict_inputs(rng, B)
    cc32 = GEOM.circle_centers.astype(np.float32)
    want = jax.vmap(lambda e, ne, d, nd, o, a: jagents.check_collision_moving_cars(
        e, ne, d, nd, o, a, jnp.asarray(cc32), GEOM.radius, cfg.frame_window, cfg.n_frames))(
        *(jnp.asarray(x) for x in (ego, n_ego, detail, n_detail, obs, active)))
    got = agents.check_collision_moving_cars(
        _t(ego), _t(n_ego), _t(detail), _t(n_detail), _t(obs), _t(active), _t(cc32),
        GEOM.radius, cfg.frame_window, cfg.n_frames)
    found = np.asarray(want.found)
    assert 0 < found.sum() < B
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.frame_idx.numpy(), np.asarray(want.frame_idx))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))

    wf, wi = jax.vmap(jagents.cutoff_index_by_position)(
        jnp.asarray(detail), jnp.asarray(n_detail), want.xy)
    gf, gi = agents.cutoff_index_by_position(_t(detail), _t(n_detail), got.xy)
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gf.numpy()[found].all()


def scan_rows(monkeypatch, n_obs, cfg, rows):
    """Set the conflict scan's budget to ``rows`` rows of ``n_obs``
    obstacles (0: one element, below a row)."""
    per_row = collision.scan_row_elements(n_obs, len(GEOM.circle_centers), cfg.frame_window,
                                          cfg.n_frames)
    monkeypatch.setattr(collision, "SCAN_ELEMENTS", max(1, rows * per_row))


@pytest.mark.parametrize("rows", [0, 1, 2, 3, 5, 7, 31, 32, 33])
def test_conflict_scan_in_row_slices_is_the_whole_scan(rows, monkeypatch):
    """32 rows scanned in slices of ``rows`` (the last one short where
    ``rows`` does not divide 32): the whole scan's bits, JAX's results."""
    rng = np.random.default_rng(5)
    ego, n_ego, detail, n_detail, obs, active, cfg = _conflict_inputs(rng, 32)
    cc32 = GEOM.circle_centers.astype(np.float32)
    args = (_t(ego), _t(n_ego), _t(detail), _t(n_detail), _t(obs), _t(active), _t(cc32),
            GEOM.radius, cfg.frame_window, cfg.n_frames)
    whole = agents.check_collision_moving_cars(*args)
    assert 0 < int(whole.found.sum()) < 32
    scan_rows(monkeypatch, obs.shape[1], cfg, rows)
    assert chip_smoke._same_tree(agents.check_collision_moving_cars(*args), whole)
    want = jax.vmap(lambda e, ne, d, nd, o, a: jagents.check_collision_moving_cars(
        e, ne, d, nd, o, a, jnp.asarray(cc32), GEOM.radius, cfg.frame_window, cfg.n_frames))(
        *(jnp.asarray(x) for x in (ego, n_ego, detail, n_detail, obs, active)))
    np.testing.assert_array_equal(whole.found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(whole.frame_idx.numpy(), np.asarray(want.frame_idx))


def test_first_hit_key_overflow_is_refused():
    """8 frames x 2 x 20 obstacles x 10^7 shifts x 2 > 2^31 - 1: refused
    before anything is computed."""
    z = torch.zeros
    with pytest.raises(ValueError, match="overflow"):
        agents.check_collision_moving_cars(
            z(1, 8, 3), z(1, dtype=torch.int32), z(1, 8, 3), z(1, dtype=torch.int32),
            z(1, 20, 35, 3), z(1, 20, dtype=torch.bool), z(2, 2), 1.0, 5_000_000, 8)


def test_goal_test_and_deviation_match_jax():
    rng = np.random.default_rng(9)
    B, N = 256, 300
    course = _curves(rng, B, N)
    goal = course[:, -1, :2] + rng.normal(0, 0.9, (B, 2)).astype(np.float32)
    state = np.concatenate([course[:, -1, :2], rng.choice([0.0, 0.05, 0.5], (B, 1)),
                            course[:, -1, 2:]], 1).astype(np.float32)
    tidx = rng.integers(N - 8, N, B).astype(np.int32)
    vlen = np.full(B, N, np.int32)
    jcfg, cfg = JaxMPCConfig(), MPCConfig()
    want = np.asarray(jax.vmap(lambda s, g, i, n: jcontroller.is_goal(s, g, i, n, jcfg))(
        *(jnp.asarray(x) for x in (state, goal, tidx, vlen))))
    got = is_goal(_t(state), _t(goal), _t(tidx), _t(vlen), cfg)
    assert 0 < want.sum() < B
    np.testing.assert_array_equal(got.numpy(), want)
    wdev = np.asarray(jax.vmap(jcontroller.xref_deviation)(
        jnp.asarray(state), jnp.asarray(course), jnp.asarray(tidx)))
    np.testing.assert_allclose(xref_deviation(_t(state), _t(course), _t(tidx)).numpy(), wdev,
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- builder and engine --

@pytest.fixture(scope="module")
def fleets():
    """The same 16-scenario fleet from both packages' builders."""
    kw = dict(n_steps=40, planner="host", starts=(1, 4), turns=(1, 2))
    jax_fleet = japi.sample_intersection_fleet_batched(16, np.random.default_rng(5), **kw)
    port_fleet = api.sample_intersection_fleet_batched(16, np.random.default_rng(5),
                                                       device="cpu", **kw)
    return jax_fleet, port_fleet


def _assert_tree_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got._fields), path
        for k, v in want.items():
            _assert_tree_equal(v, getattr(got, k), f"{path}.{k}")
        return
    g = got.numpy()
    np.testing.assert_array_equal(g, want.astype(g.dtype), err_msg=path)


def test_fleet_builder_matches_jax(fleets):
    (_, jw, js, jmeta), (_, pw, ps, pmeta) = fleets
    _assert_tree_equal(_np(jw), pw, "world")
    _assert_tree_equal(_np(js), ps, "state")
    assert pw.course.dtype == torch.float32 and pw.agent_params.speed.dtype == torch.float32
    for k in ("start_pos", "turn_indicator", "n_agents"):
        np.testing.assert_array_equal(pmeta[k], jmeta[k])
    assert pmeta["planner_stats"]["planner"] == "host"


def _first(tree, rows):
    return jax.tree.map(lambda a: a[:rows], tree)


@pytest.fixture(scope="module")
def jax_ticks(fleets):
    """JAX states s_0..s_10 and telemetry of 10 ticks, tick by tick, and
    the scanned episode."""
    geom, jw, js, _ = fleets[0]
    cfg = JaxEngineConfig()
    jw, js = _first(jw, N_ROWS), _first(js, N_ROWS)
    tick = jax.jit(lambda w, s: jfleet.engine_tick_fleet(w, s, cfg, geom, use_pallas=False))
    states, tels = [js], []
    for _ in range(N_TICKS):
        st, tel = tick(jw, states[-1])
        states.append(st)
        tels.append(tel)
    final, tel_scan = jax.jit(lambda w, s: jfleet.run_fleet_episodes(
        w, s, cfg, geom, N_TICKS, use_pallas=False))(jw, js)
    return jw, states, tels, final, tel_scan


def test_engine_tick_matches_jax_tick_by_tick(jax_ticks):
    jw, states, tels, _, _ = jax_ticks
    cfg = EngineConfig()
    world = world_from_numpy(_np(jw), device="cpu")
    assert world.agent_params.speed.dtype == torch.float64   # kept as JAX made it
    n_collisions = 0
    for k in range(N_TICKS):
        st = engine_state_from_numpy(_np(states[k]), device="cpu")
        new, tel = engine_tick_fleet(world, st, cfg, GEOM)
        want, wtel = states[k + 1], tels[k]
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0)
        np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4, rtol=0)
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(), np.asarray(getattr(wtel, name)),
                                          err_msg=f"tick {k} {name}")
        for name in ("agent_idx", "cutoff_len", "done", "ticks_to_goal", "tick", "first_tick"):
            np.testing.assert_array_equal(getattr(new, name).numpy(), np.asarray(getattr(want, name)),
                                          err_msg=f"tick {k} {name}")
        np.testing.assert_allclose(new.agents.pose.numpy(), np.asarray(want.agents.pose),
                                   atol=1e-9, rtol=0)
        n_collisions += int(tel.collision_found.sum())
    assert n_collisions > 0   # the conflict scan and the cutoff took part


def test_fleet_episode_and_batch_runner_match_jax(jax_ticks):
    jw, states, _, jfinal, jtel = jax_ticks
    cfg = EngineConfig()
    world = world_from_numpy(_np(jw), device="cpu")
    st0 = engine_state_from_numpy(_np(states[0]), device="cpu")
    final, tel = run_fleet_episodes(world, st0, cfg, GEOM, N_TICKS)
    assert tel.x.shape == (N_TICKS, N_ROWS)
    np.testing.assert_allclose(tel.x.numpy(), np.asarray(jtel.x), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tel.steer.numpy(), np.asarray(jtel.steer), atol=5e-4, rtol=0)
    np.testing.assert_array_equal(tel.done.numpy(), np.asarray(jtel.done))
    np.testing.assert_allclose(final.ego.numpy(), np.asarray(jfinal.ego), atol=2e-4, rtol=0)

    bfinal, btel, summary = run_batch_episodes(world, st0, cfg, GEOM, N_TICKS)
    assert btel.x.shape == (N_ROWS, N_TICKS)
    torch.testing.assert_close(btel.x, tel.x.T, rtol=0, atol=0)
    assert int(summary["n_done"]) == int(np.asarray(jfinal.done).sum())
    assert int(summary["ticks_to_goal_sum"]) == int(np.asarray(jfinal.ticks_to_goal).sum())
    assert int(summary["n_unsolved_ticks"]) == int((~np.asarray(jtel.solved)).sum())


def test_sliced_scan_ticks_match_the_whole_tick_and_jax_chunked_ticks(fleets, monkeypatch):
    geom, jw, js, _ = fleets[0]
    jcfg, cfg = JaxEngineConfig(), EngineConfig()
    jw, js = _first(jw, SLICE_ROWS), _first(js, SLICE_ROWS)
    ticks = {c: jax.jit(lambda w, s, c=c: jfleet.engine_tick_fleet(
        w, s, jcfg, geom, use_pallas=False, pre_chunk=c)) for c in (2, 0)}
    world = world_from_numpy(_np(jw), device="cpu")
    n_obs = world.agent_params.active.shape[1]
    n_collisions = 0
    for k in range(N_TICKS):
        st = engine_state_from_numpy(_np(js), device="cpu")
        new, tel = engine_tick_fleet(world, st, cfg, GEOM)
        for rows in (1, 2, 4):
            with monkeypatch.context() as m:
                scan_rows(m, n_obs, cfg, rows)
                sliced = engine_tick_fleet(world, st, cfg, GEOM)
            assert chip_smoke._same_tree(sliced, (new, tel)), f"tick {k}, rows {rows}"
        assert isinstance(tel, Telemetry)
        for pre_chunk, tick in ticks.items():
            want, wtel = tick(jw, js)
            msg = f"tick {k}, JAX pre_chunk={pre_chunk}"
            np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0,
                                       err_msg=msg)
            np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4,
                                       rtol=0, err_msg=msg)
            for name in ("done", "collision_found", "cutoff_len", "solved"):
                np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                              np.asarray(getattr(wtel, name)), err_msg=msg)
            for name in ("agent_idx", "cutoff_len", "done", "ticks_to_goal", "tick"):
                np.testing.assert_array_equal(getattr(new, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=msg)
        js = want
        n_collisions += int(tel.collision_found.sum())
    assert n_collisions > 0   # the conflict scan and the cutoff took part


def test_single_scenario_world_and_state_match_jax():
    """``make_world``/``init_engine_state`` of one scenario, stacked, equal
    the JAX package's (its float agent fields cast to the port's float32)."""
    from mpc_for_av_at_intersection_tpu.engine import init_engine_state as jinit
    from mpc_for_av_at_intersection_tpu.engine import make_world as jmake
    from mpc_for_av_at_intersection_tpu.parallel import stack_states as jstack_states
    from mpc_for_av_at_intersection_tpu.parallel import stack_worlds as jstack_worlds
    from mpc_for_av_at_intersection_tpu_torch.engine import init_engine_state, make_world
    from mpc_for_av_at_intersection_tpu_torch.parallel import stack_states, stack_worlds

    rng = np.random.default_rng(2)
    cfg, jcfg = EngineConfig(), JaxEngineConfig()
    worlds, states, jworlds, jstates = [], [], [], []
    for i, traj in enumerate(_curves(rng, 3, 300).astype(np.float64)):
        rows = [jagents.make_t_intersection_agent(direction=d, turning=bool(i % 2), speed=6.0,
                                                  offset=1.5 * i) for d in (1, -1)[: i + 1]]
        params, ag = jagents.stack_agents(rows, n_slots=cfg.n_agents)
        tparams, tag = agents.stack_agents(rows, n_slots=cfg.n_agents)
        w = make_world(traj, tparams, cfg, device="cpu")
        worlds.append(w)
        states.append(init_engine_state(w, tag, cfg, 40, device="cpu"))
        jw = jmake(traj, params, jcfg)
        jworlds.append(jw)
        jstates.append(jinit(jw, ag, jcfg, 40))
    _assert_tree_equal(_np(jstack_worlds(jworlds)), stack_worlds(worlds), "world")
    _assert_tree_equal(_np(jstack_states(jstates)), stack_states(states), "state")


def test_state_carry_round_trips(fleets):
    _, pw, ps, _ = fleets[1]
    w2 = world_from_numpy(world_to_numpy(pw), device="cpu")
    s2 = engine_state_from_numpy(engine_state_to_numpy(ps), device="cpu")
    for a, b in zip(jax.tree.leaves(tuple(pw)), jax.tree.leaves(tuple(w2))):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(tuple(ps)), jax.tree.leaves(tuple(s2))):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
