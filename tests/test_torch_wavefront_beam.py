"""PyTorch port: the beam engine (``wavefront_search``) against the JAX package.

The port's ``plan_courses_device(engine="beam", device="cpu")`` (K4's
plain version) against the JAX package's ``plan_courses_device(
engine="beam", collision="xla")`` on the same scenarios. Bars: found
identical, cost within 1e-5 relative, ``n_edges`` and ``oob`` equal,
trajectories within 1e-3 m.

The two packages' float32 sines and cosines differ by an ulp on ~5% of
arguments (XLA's vector library against PyTorch's), so two candidate cells
whose f is equal in exact arithmetic can be ordered differently by the
top-F selection. On the free area, the right turn and the obstacle-weighted
left turn this never decides anything and the searches are
equal. On the straight crossing (start 1) it does: at iteration 6 two
mirror-image cells either side of the lane axis swap places in the
frontier, and from there the searches expand different cells (oob 5114
against 5052). That setup is held to the JAX test's band of the host
search instead (``tests/test_wavefront.py:200-221``: 0.85-1.10 x cost),
with a valid trajectory.

Also: the grid rule takes the beam engine exactly where the JAX rule does
(checked on far-spread batches without running their searches),
``engine="auto"`` stays serial A*, and the backtrack from a goal candidate
walks from its parent cell with the goal primitive as the last edge.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu.lattice import SearchWeights as JaxWeights
from mpc_for_av_at_intersection_tpu.lattice import wavefront as jwavefront
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.worlds import free_area as jax_free_area
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu_torch.lattice import (
    MotionPrimitiveSearch,
    SearchWeights,
    WavefrontConfig,
    grid_for,
    primitive_table,
    wavefront,
)
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.ops import collision
from mpc_for_av_at_intersection_tpu_torch.worlds import free_area, intersection
from mpc_for_av_at_intersection_tpu_torch.worlds.obstacles import check_collision

torch.set_num_threads(2)

ML_OBST = dict(h_obstacle=0.5, c_center=0.05)
SETUPS = {
    # name: (port scenarios, JAX scenarios, port weights, JAX weights, exact)
    "free_area": (lambda: [free_area(goal_distance=15.0), free_area(goal_distance=20.0, angle=0.6)],
                  lambda: [jax_free_area(goal_distance=15.0),
                           jax_free_area(goal_distance=20.0, angle=0.6)],
                  SearchWeights.modified, JaxWeights.modified, True),
    "right_turn": (lambda: [intersection(turn_indicator=3, start_pos=2)],
                   lambda: [jax_intersection(turn_indicator=3, start_pos=2)],
                   SearchWeights.modified, JaxWeights.modified, True),
    "obstacle_weighted": (lambda: [intersection(turn_indicator=1, start_pos=4)],
                          lambda: [jax_intersection(turn_indicator=1, start_pos=4)],
                          lambda: SearchWeights.multi_lane(**ML_OBST),
                          lambda: JaxWeights.multi_lane(**ML_OBST), True),
    "straight": (lambda: [intersection(turn_indicator=2, start_pos=1)],
                 lambda: [jax_intersection(turn_indicator=2, start_pos=1)],
                 SearchWeights.modified, JaxWeights.modified, False),
}


def _assert_valid_course(sc, traj, geom, obstacles):
    """Starts at the start, continuous, ends at the goal area; with
    ``obstacles``, also clear of every obstacle at every point (the check
    of ``tests/test_wavefront.py:77-109``, which holds for the default
    weights: the search tests collisions at the primitives' sampled
    points only)."""
    np.testing.assert_allclose(traj[0], np.asarray(sc.start), atol=1e-5)
    assert np.linalg.norm(np.diff(traj[:, :2], axis=0), axis=1).max() < 0.2
    assert sc.goal_area.distance_to_point(traj[-1, :2]) < 0.15
    if obstacles:
        c, s = np.cos(traj[:, 2]), np.sin(traj[:, 2])
        pts = np.concatenate([np.stack([traj[:, 0] + c * ox - s * oy,
                                        traj[:, 1] + s * ox + c * oy], 1)
                              for ox, oy in geom.circle_centers])
        for o in sc.obstacles:
            assert not check_collision(o.halfplanes(margin=geom.radius), pts)


@pytest.mark.parametrize("name", list(SETUPS))
def test_beam_matches_the_jax_beam(name):
    port_sc, jax_sc, w, jw, exact = SETUPS[name]
    scen = port_sc()
    geom = bicycle_geometry()
    before = collision.frontier_collision.launches
    got = wavefront.plan_courses_device(scen, geom, weights=w(), engine="beam", device="cpu")
    assert collision.frontier_collision.launches == before   # CPU: the plain version
    want = jwavefront.plan_courses_device(jax_sc(), jax_geometry(), weights=jw(), engine="beam",
                                          collision="xla")
    found = np.asarray(want.found)
    assert found.all()
    np.testing.assert_array_equal(got.found.numpy(), found)
    traj, n_pts = got.trajectory.numpy(), got.n_points.numpy()
    for i, sc in enumerate(scen):
        _assert_valid_course(sc, traj[i, : n_pts[i]], geom, obstacles=not exact)
    if exact:
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
        np.testing.assert_array_equal(got.n_edges.numpy(), np.asarray(want.n_edges))
        np.testing.assert_array_equal(got.n_points.numpy(), np.asarray(want.n_points))
        np.testing.assert_array_equal(got.oob.numpy(), np.asarray(want.oob))
        jtraj = np.asarray(want.trajectory)
        for i in range(len(scen)):
            np.testing.assert_allclose(traj[i, : n_pts[i]], jtraj[i, : n_pts[i]], atol=1e-3, rtol=0)
    else:
        table = primitive_table(geom)
        for i, sc in enumerate(scen):
            host, _, _ = MotionPrimitiveSearch(sc, geom, table, margin=geom.radius,
                                               weights=w()).run()
            for cost in (float(got.cost[i]), float(np.asarray(want.cost)[i])):
                assert 0.85 * host - 1e-6 <= cost <= 1.10 * host + 1e-6


def _spread(d):
    """Two free-area scenarios driving d metres along +x and +y."""
    return ([free_area(goal_distance=d), free_area(goal_distance=d, angle=np.pi / 2)],
            [jax_free_area(goal_distance=d), jax_free_area(goal_distance=d, angle=np.pi / 2)])


@pytest.mark.parametrize("d,engine,ntheta", [(40.0, "astar", 40), (262.0, "astar", 32),
                                             (330.0, "beam", 32)])
def test_grid_rule_takes_the_beam_engine_where_jax_does(d, engine, ntheta, monkeypatch):
    """The JAX planner's choice is read from which path it calls; neither
    search runs."""
    scen, jscen = _spread(d)
    seen = []
    monkeypatch.setattr(jwavefront, "_astar_courses",
                        lambda arrs, geom, w, cfg, *a, **k: seen.append(("astar", cfg)))
    monkeypatch.setattr(jwavefront, "_planner_fn",
                        lambda cfg, *a: (lambda *b: seen.append(("beam", cfg))))
    jwavefront.plan_courses_device(jscen, jax_geometry(), engine="astar")
    got_engine, cfg = grid_for(scen)
    assert (got_engine, cfg.ntheta) == (engine, ntheta)
    assert [(e, dataclasses.asdict(c)) for e, c in seen] == [(engine, dataclasses.asdict(cfg))]
    assert grid_for(scen, "beam") == ("beam", WavefrontConfig.for_scenarios(scen))


def test_auto_engine_is_serial_astar(monkeypatch):
    calls = []
    monkeypatch.setattr(wavefront, "wavefront_search",
                        lambda *a, **k: calls.append("beam"))
    res = wavefront.plan_courses_device([free_area(goal_distance=15.0)], bicycle_geometry(),
                                        max_expansions=64, device="cpu")
    assert calls == [] and bool(res.found[0])
    with pytest.raises(ValueError, match="engine"):
        wavefront.plan_courses_device([free_area()], bicycle_geometry(), engine="xla",
                                      device="cpu")


def test_backtrack_from_a_goal_candidate():
    """Cells 1 <- 2 hang off the start cell 0; the goal candidate's parent
    is cell 2, its primitive 0, so the chain has three edges and needs
    E >= 3 steps (two cells with a primitive, then the start)."""
    P, K = 2, 4
    points = torch.zeros((P, K, 3))
    points[:, :, 0] = torch.linspace(0, 1.5, K)
    parent = torch.full((1, 6), -1, dtype=torch.int32)
    prim = torch.full((1, 6), -1, dtype=torch.int32)
    parent[0, 1:3] = torch.tensor([0, 1], dtype=torch.int32)
    prim[0, 1:3] = 0
    found = torch.tensor([True])
    args = (found, torch.tensor([2]), parent, prim, torch.zeros((1, 3)), points)
    traj, n_pts, n_edges, ok = wavefront._backtrack_replay_batch(*args, E=3,
                                                                 goal_prim=torch.tensor([1]))
    assert ok.tolist() == [True] and n_edges.tolist() == [3] and n_pts.tolist() == [9]
    np.testing.assert_allclose(traj[0, :9, 0].numpy(), np.arange(9) * 0.5, atol=1e-6)
    _, _, n_edges, ok = wavefront._backtrack_replay_batch(*args, E=2, goal_prim=torch.tensor([1]))
    assert ok.tolist() == [False] and n_edges.tolist() == [0]
