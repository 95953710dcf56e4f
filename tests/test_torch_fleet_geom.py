"""PyTorch port: the sampled-geometry fleet builder and the loop builder.

- ``sample_intersection_fleet_geom(8, default_rng(0), planner="native")``
  of both packages: the geometry draws (one junction of the eight is
  unplannable at the 150k budget and is redrawn), the planner stats, the
  courses and every world and state array are equal (the JAX arrays, via
  ``world_to_numpy``/``engine_state_to_numpy``'s layout, cast to the port's
  dtypes). Then 4 fleet ticks from the carried JAX state, tick by tick, on
  the 1536-point course buffer, with ``tests/test_fleet_engine.py``'s bars:
  x atol 2e-4, steer atol 5e-4; ``done``, ``agent_idx``, ``cutoff_len``,
  ``collision_found`` exact.
- ``planner="device"`` at S=6 on the CPU (K3's plain version, its budget
  cut to 1000 expansions so that the native core re-plans the misses; one
  junction has no path and is redrawn): every course is present, starts
  at its start and ends at its goal area; the counts add up to S.
- The chunked device path (chunks of 4 over the same 6 scenarios) gives
  the same courses as one chunk, and its stats count the real rows only.
- The loop builder ``sample_intersection_fleet`` equals the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu.engine import EngineConfig as JaxEngineConfig
from mpc_for_av_at_intersection_tpu.engine import fleet as jfleet
from mpc_for_av_at_intersection_tpu.native import native_available as jax_native_available
from mpc_for_av_at_intersection_tpu.parallel import stack_states as jstack_states
from mpc_for_av_at_intersection_tpu.parallel import stack_worlds as jstack_worlds
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    engine_state_from_numpy,
    engine_state_to_numpy,
    engine_tick_fleet,
    world_from_numpy,
    world_to_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.native import native_available
from mpc_for_av_at_intersection_tpu_torch.parallel import stack_states, stack_worlds
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

torch.set_num_threads(2)

S, N_TICKS = 8, 4


def _np(tree):
    """Nested dicts of numpy arrays from a JAX NamedTuple tree."""
    if hasattr(tree, "_asdict"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def _assert_equal(want, got, path=""):
    """Nested dicts of numpy arrays, ``got`` in the port's dtypes."""
    assert set(want) == set(got), path
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal(v, got[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=f"{path}.{k}")


@pytest.fixture(scope="module")
def fleets():
    if not (native_available() and jax_native_available()):
        pytest.skip("no g++: the native search cannot be built")
    jax_fleet = japi.sample_intersection_fleet_geom(S, np.random.default_rng(0), n_steps=40,
                                                    planner="native")
    port_fleet = api.sample_intersection_fleet_geom(S, np.random.default_rng(0), n_steps=40,
                                                    planner="native", device="cpu")
    return jax_fleet, port_fleet


def test_geometry_fleet_matches_jax(fleets):
    (_, jw, js, jmeta), (_, pw, ps, pmeta) = fleets
    for k in ("start_pos", "turn_indicator", "road", "island", "corner_radius", "n_agents"):
        np.testing.assert_array_equal(pmeta[k], jmeta[k], err_msg=k)
    for k, v in jmeta["planner_stats"].items():
        assert pmeta["planner_stats"][k] == v, k
    assert pmeta["planner_stats"]["n_resampled_geometry"] == 1
    assert pw.course.shape == (S, 1536, 3) and pw.course.dtype == torch.float32
    _assert_equal(_np(jw), world_to_numpy(pw), "world")
    _assert_equal(_np(js), engine_state_to_numpy(ps), "state")


def test_geometry_fleet_ticks_match_jax(fleets):
    (geom, jw, js, _), _ = fleets
    jcfg, cfg = JaxEngineConfig(n_traj=1536), EngineConfig(n_traj=1536)
    tick = jax.jit(lambda w, s: jfleet.engine_tick_fleet(w, s, jcfg, geom, use_pallas=False))
    world = world_from_numpy(_np(jw), device="cpu")
    st = js
    for k in range(N_TICKS):
        new, tel = engine_tick_fleet(world, engine_state_from_numpy(_np(st), device="cpu"), cfg,
                                     geom)
        st, wtel = tick(jw, st)
        np.testing.assert_allclose(tel.x.numpy(), np.asarray(wtel.x), atol=2e-4, rtol=0)
        np.testing.assert_allclose(tel.steer.numpy(), np.asarray(wtel.steer), atol=5e-4, rtol=0)
        for name in ("done", "collision_found", "cutoff_len", "solved"):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(wtel, name)), err_msg=f"{k} {name}")
        for name in ("agent_idx", "cutoff_len", "done"):
            np.testing.assert_array_equal(getattr(new, name).numpy(),
                                          np.asarray(getattr(st, name)), err_msg=f"{k} {name}")
        assert bool(tel.solved.all())


@pytest.fixture(scope="module")
def device_fleets():
    """The device planner at S=6 in one chunk and in chunks of 4."""
    if not native_available():
        pytest.skip("no g++: the native search cannot be built")
    mp = pytest.MonkeyPatch()
    mp.setattr(api, "GEOM_MAX_EXPANSIONS", 1000)
    out = []
    try:
        for chunk in (1024, 4):
            mp.setattr(api, "GEOM_CHUNK", chunk)
            out.append(api.sample_intersection_fleet_geom(6, np.random.default_rng(0), n_steps=40,
                                                          planner="device", device="cpu"))
    finally:
        mp.undo()
    return out


def test_device_planner_gives_valid_courses(device_fleets):
    _, world, state, meta = device_fleets[0]
    stats = meta["planner_stats"]
    assert stats["planner"] == "device"
    assert stats["n_device"] + stats["n_host_fallback"] == 6
    # one junction has no path: its device miss, its native re-plan at the
    # 150k budget and its geometry redraw all take place
    assert stats["n_device"] >= 1 and stats["n_host_fallback"] >= 1
    assert stats["n_unplannable"] == stats["n_resampled_geometry"] == 1
    course, n = world.course.numpy(), world.n_course.numpy()
    for i in range(6):
        sc = intersection(turn_indicator=int(meta["turn_indicator"][i]),
                          start_pos=int(meta["start_pos"][i]), road=float(meta["road"][i]),
                          island=float(meta["island"][i]),
                          corner_radius=float(meta["corner_radius"][i]))
        assert 100 <= n[i] <= 1536
        np.testing.assert_allclose(course[i, 0, :2], np.asarray(sc.start[:2]), atol=1e-5)
        assert sc.goal_area.distance_to_point(course[i, n[i] - 1, :2]) < 0.15
    assert bool(torch.isfinite(state.ego).all())


def test_chunked_device_planning_counts_real_rows(device_fleets):
    (_, w1, _, m1), (_, w2, _, m2) = device_fleets
    torch.testing.assert_close(w2.course, w1.course, rtol=0, atol=0)
    torch.testing.assert_close(w2.n_course, w1.n_course, rtol=0, atol=0)
    for k in ("n_device", "n_host_fallback", "n_unplannable", "n_resampled_geometry"):
        assert m2["planner_stats"][k] == m1["planner_stats"][k], k
    assert m2["planner_stats"]["n_device"] + m2["planner_stats"]["n_host_fallback"] == 6


def test_loop_builder_matches_jax():
    if not (native_available() and jax_native_available()):
        pytest.skip("no g++: the native search cannot be built")
    kw = dict(n_steps=40, starts=(2, 3), turns=(1, 3), planner="native")
    _, jworlds, jstates, jmeta = japi.sample_intersection_fleet(5, np.random.default_rng(7), **kw)
    _, worlds, states, meta = api.sample_intersection_fleet(5, np.random.default_rng(7),
                                                            device="cpu", **kw)
    assert meta == jmeta
    _assert_equal(_np(jstack_worlds(jworlds)), world_to_numpy(stack_worlds(worlds)), "world")
    _assert_equal(_np(jstack_states(jstates)), engine_state_to_numpy(stack_states(states)),
                  "state")
    # the batched builder draws the same fleet from the same seed
    _, bw, _, bmeta = api.sample_intersection_fleet_batched(5, np.random.default_rng(7),
                                                            device="cpu", **kw)
    torch.testing.assert_close(bw.course, stack_worlds(worlds).course, rtol=0, atol=0)
    np.testing.assert_array_equal(bmeta["n_agents"], [m["n_agents"] for m in meta])
