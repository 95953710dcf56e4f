"""PyTorch port: K3's plain version and the course planner against the JAX
package's serial-A* Pallas kernel (interpret mode).

The three setups of ``tests/test_astar_kernel.py`` (free area; four
junctions on a shared 32-bin grid; the single-lane weighted variant) run
through JAX ``plan_courses_device(engine="astar_interpret")`` and the port's
``plan_courses_device(device="cpu")`` on the same scenarios. Both record
their raw search result on the way.

Bars: the raw search results are equal element for element (found, cost,
goal cell, expansion and oob counts, the whole parent/prim grid): both run
the same float32 steps, and the grid argmin's first index is the kernel's
tie-break. The planned courses: ``found`` identical, cost within 1e-5
relative, trajectories of equal length within 1e-3 m (the replay's sines
and cosines come from two libraries and differ in the last bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.lattice import SearchWeights as JaxSearchWeights
from mpc_for_av_at_intersection_tpu.lattice import wavefront as jwavefront
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.ops import astar_pallas
from mpc_for_av_at_intersection_tpu.worlds import free_area as jax_free_area
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu_torch.lattice import SearchWeights, WavefrontConfig
from mpc_for_av_at_intersection_tpu_torch.lattice import wavefront
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.ops import astar
from mpc_for_av_at_intersection_tpu_torch.worlds import free_area, intersection

torch.set_num_threads(2)

JUNCTIONS = [(1, 1), (2, 3), (3, 2), (4, 1)]
SETUPS = {
    # name: (port scenarios, JAX scenarios, weights name, shared 32-bin grid, max expansions)
    "free_area": (lambda: [free_area(goal_distance=15.0)],
                  lambda: [jax_free_area(goal_distance=15.0)], "modified", False, 256),
    "junctions": (lambda: [intersection(turn_indicator=t, start_pos=s) for s, t in JUNCTIONS],
                  lambda: [jax_intersection(turn_indicator=t, start_pos=s) for s, t in JUNCTIONS],
                  "modified", True, 4096),
    "single_lane": (lambda: [intersection(turn_indicator=2, start_pos=1)],
                    lambda: [jax_intersection(turn_indicator=2, start_pos=1)], "single_lane",
                    False, 4096),
}


def _record(module, name, monkeypatch, seen):
    fn = getattr(module, name)

    def recording(*a, **k):
        out = fn(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, recording)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results per setup, computed once: (WavefrontResult, raw search)."""
    cache = {}

    def run(name):
        if name not in cache:
            _, jax_sc, wname, shared, max_exp = SETUPS[name]
            scen = jax_sc()
            cfg = jwavefront.WavefrontConfig.for_scenarios(scen) if shared else None
            seen = []
            mp = pytest.MonkeyPatch()
            _record(astar_pallas, "astar_search_batch", mp, seen)
            try:
                res = jwavefront.plan_courses_device(
                    scen, jax_geometry(), weights=getattr(JaxSearchWeights, wname)(), cfg=cfg,
                    engine="astar_interpret", max_expansions=max_exp, dtype=jnp.float32)
            finally:
                mp.undo()
            cache[name] = (res, seen[0])
        return cache[name]

    return run


@pytest.mark.parametrize("name", list(SETUPS))
def test_planner_matches_jax_astar_kernel(name, jax_runs, monkeypatch):
    port_sc, _, wname, shared, max_exp = SETUPS[name]
    scen = port_sc()
    cfg = WavefrontConfig.for_scenarios(scen) if shared else None
    seen = []
    _record(wavefront, "astar_search_batch", monkeypatch, seen)
    got = wavefront.plan_courses_device(scen, bicycle_geometry(),
                                        weights=getattr(SearchWeights, wname)(), cfg=cfg,
                                        max_expansions=max_exp, device="cpu")
    want, want_raw = jax_runs(name)

    raw = seen[0]
    for field in want_raw._fields:
        a, b = getattr(raw, field).numpy(), np.asarray(getattr(want_raw, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)

    found = np.asarray(want.found)
    assert found.all()
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-5)
    np.testing.assert_array_equal(got.n_points.numpy(), np.asarray(want.n_points))
    np.testing.assert_array_equal(got.n_edges.numpy(), np.asarray(want.n_edges))
    np.testing.assert_array_equal(got.oob.numpy(), np.asarray(want.oob))
    traj, jtraj = got.trajectory.numpy(), np.asarray(want.trajectory)
    for i, sc in enumerate(scen):
        n = int(got.n_points[i])
        assert n > 0
        np.testing.assert_allclose(traj[i, :n], jtraj[i, :n], atol=1e-3, rtol=0)
        # each edge stores its first K-1 points, so the course ends one
        # arc sample (~0.083 m) short of the goal pose
        assert sc.goal_area.distance_to_point(traj[i, n - 1, :2]) < 0.15


def test_backtrack_marks_an_incomplete_chain_unsolved():
    """A parent chain that does not reach the start within E steps is
    reported as not found (the replay would otherwise be a corrupted
    prefix). Three edges take four steps: the last reads the start cell."""
    P, K = 3, 4
    points = torch.zeros((P, K, 3))
    points[:, :, 0] = torch.linspace(0, 1.5, K)
    N = 8
    parent = torch.full((2, N), -1, dtype=torch.int32)
    prim = torch.full((2, N), -1, dtype=torch.int32)
    for row in range(2):   # chain 3 <- 2 <- 1 <- 0 (start)
        parent[row, 1:4] = torch.tensor([0, 1, 2], dtype=torch.int32)
        prim[row, 1:4] = 0
    found = torch.tensor([True, True])
    goal = torch.tensor([3, 3], dtype=torch.int32)
    start = torch.zeros((2, 3))
    traj, n_pts, n_edges, ok = wavefront._backtrack_replay_batch(found, goal, parent, prim,
                                                                 start, points, E=4)
    assert ok.tolist() == [True, True] and n_edges.tolist() == [3, 3]
    np.testing.assert_allclose(traj[0, :int(n_pts[0]), 0].numpy(),
                               np.arange(9) * 0.5, atol=1e-6)
    _, _, n_edges, ok = wavefront._backtrack_replay_batch(found, goal, parent, prim, start,
                                                          points, E=3)
    assert ok.tolist() == [False, False] and n_edges.tolist() == [0, 0]


def test_rows_tested_counts_the_early_exit_collision_work():
    """``rows_tested`` of one expansion from the start equals a point-by-point
    count of the kernel's loop: an obstacle's rows up to its first positive
    one (all 8, padding included, when the point is inside), stopping after
    the first obstacle hit; dead obstacle slots and masked points read none."""
    from mpc_for_av_at_intersection_tpu_torch.lattice import primitive_table, prepare_primitives
    from mpc_for_av_at_intersection_tpu_torch.worlds.scenario import (
        compile_scenario,
        stack_scenario_arrays,
    )

    geom = bicycle_geometry()
    sc = [free_area(goal_distance=15.0)]
    arrs = stack_scenario_arrays([compile_scenario(s, margin=geom.radius) for s in sc])
    start = torch.as_tensor(np.asarray(arrs.start), dtype=torch.float32)
    sx, sy, sth = (float(v) for v in start[0])
    assert abs(sth) < 1e-6   # the boxes below lie ahead along +x
    O = np.asarray(arrs.obstacle_valid).shape[1]
    hp = torch.zeros((1, O, 4, 3))
    ov = torch.zeros((1, O), dtype=torch.bool)
    # slot 0: a box across the path 1-3 m ahead; slot 1 dead; slot 2 a box
    # behind it that points inside slot 0 never reach
    for o, (x1, x2, y1, y2) in ((0, (sx + 1.0, sx + 3.0, sy - 0.4, sy + 0.4)),
                                (2, (sx + 2.0, sx + 6.0, sy - 3.0, sy + 3.0))):
        hp[0, o] = torch.tensor([[-1.0, 0.0, x1], [1.0, 0.0, -x2], [0.0, -1.0, y1],
                                 [0.0, 1.0, -y2]])
        ov[0, o] = True
    prims = prepare_primitives(primitive_table(geom), geom, np.float32)
    cfg = WavefrontConfig.for_scenarios(sc, ntheta=40)
    args = (hp, ov, start, torch.as_tensor(np.asarray(arrs.goal_point), dtype=torch.float32),
            torch.as_tensor(np.asarray(arrs.goal_area_corners), dtype=torch.float32),
            torch.as_tensor(np.asarray(arrs.goal_theta_tol), dtype=torch.float32), prims, cfg,
            SearchWeights.modified())
    res = astar.astar_search_reference(*args, max_expansions=1)
    assert int(res.n_expansions[0]) == 1

    x = astar._prepare(*args, max_expansions=1)
    rows = x.hp.reshape(O, astar.HH, 3).numpy()
    cs, sn = torch.cos(start[:, 2:3]), torch.sin(start[:, 2:3])
    wx = (start[:, 0:1] + cs * x.cc[:, 0] - sn * x.cc[:, 1])[0].numpy()
    wy = (start[:, 1:2] + sn * x.cc[:, 0] + cs * x.cc[:, 1])[0].numpy()
    want, hits = 0, 0
    for i in np.flatnonzero(x.cc_mask.numpy()):
        for o in range(O):
            if not bool(ov[0, o]):
                continue
            inside = True
            for a, b, c in rows[o]:
                want += 1
                if a * wx[i] + b * wy[i] + c > np.float32(0.0):
                    inside = False
                    break
            if inside:
                hits += 1
                break
    assert 0 < hits < int(x.cc_mask.sum())
    assert int(res.rows_tested[0]) == want
    # a search with no live obstacle reads no rows
    none = astar.astar_search_reference(hp, torch.zeros_like(ov), *args[2:], max_expansions=4)
    assert int(none.rows_tested[0]) == 0 and int(none.n_expansions[0]) == 4


def test_level1_block_covers_every_cell_within_its_budget():
    """The kernel's min tree cuts the f grid into blocks of ``level1_block(N)``
    cells, one 64-bit level-1 key each in shared memory: for every grid from 1
    cell to the largest the planner's grid rule admits (28 bytes a cell
    within 80 MB), the block is the least power of two >= 128 whose keys fit
    ``L1_MAX`` (16 KB), and the blocks cover every cell, the last one
    partly."""
    largest = int(wavefront._GRID_BUDGET // wavefront._GRID_BYTES_PER_CELL)
    edges = [m * astar.L1_MAX * 2 ** k + d for k in range(13) for m in (1, 2) for d in (-1, 0, 1)]
    sizes = sorted({n for n in [*range(1, 4097), *edges, 107 * 107 * 40, 100 * 100 * 40,
                                298 * 298 * 32, largest] if 1 <= n <= largest})
    assert sizes[-1] == largest == 2857142
    for n in sizes:
        blk = astar.level1_block(n)
        entries = -(-n // blk)
        assert blk >= astar.MIN_BLOCK and blk & (blk - 1) == 0, n
        assert entries <= astar.L1_MAX and 8 * entries <= 16 * 1024, n
        assert (entries - 1) * blk < n <= entries * blk, n          # every cell, no empty block
        assert blk == astar.MIN_BLOCK or -(-n // (blk // 2)) > astar.L1_MAX, n   # the least
    assert astar.level1_block(107 * 107 * 40) == 256 and -(-107 * 107 * 40 // 256) == 1789
    assert astar.level1_block(largest) == 2048


def test_plain_search_gives_the_kernels_pinned_junction_digest():
    """K3's plain version on the CPU gives, bit for bit, the result that
    ``chip_smoke.py`` pins for the kernel on phase 7's inputs (the 12
    standard junctions, 8192 expansions): the same float32 steps and the
    same argmin on both sides."""
    import chip_smoke

    _, _, args, _ = chip_smoke.k3_junction_inputs(torch.device("cpu"))
    res = astar.astar_search_reference(*args, max_expansions=chip_smoke.K3_JUNCTION_EXP)
    assert chip_smoke._digest(res) == chip_smoke.PINNED_DIGESTS["k3_junctions"]


def test_cpu_search_counts_no_launch_and_other_devices_reach_the_kernel_path():
    sc = [free_area(goal_distance=15.0)]
    before = astar.astar_search_batch.launches
    res = wavefront.plan_courses_device(sc, bicycle_geometry(), max_expansions=64, device="cpu")
    assert bool(res.found[0]) and astar.astar_search_batch.launches == before
    # ``meta`` tensors stand in for CUDA ones: refused on the kernel path,
    # before anything is built or launched
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.plan_courses_device(sc, bicycle_geometry(), max_expansions=64, device="meta")
    assert astar.astar_search_batch.launches == before


def test_beam_engine_and_native_planner_are_not_ported():
    """The two planners this test once expected to raise now run: the beam
    engine (its CUDA collision kernel refuses CPU tensors) and the native
    host search, which plans what the Python search plans."""
    res = wavefront.plan_courses_device([free_area(goal_distance=15.0)], bicycle_geometry(),
                                        engine="beam", device="cpu")
    assert bool(res.found[0]) and int(res.n_points[0]) > 0
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.plan_courses_device([free_area()], bicycle_geometry(), engine="beam",
                                      collision="kernel", device="cpu")
    from mpc_for_av_at_intersection_tpu_torch import api

    sc = [free_area(goal_distance=15.0)]
    courses, stats = api.plan_courses_batch(sc, bicycle_geometry(), planner="native",
                                            device="cpu")
    assert stats["planner"] == "native" and stats["n_device"] == 0
    np.testing.assert_array_equal(courses[0], api.plan_course(sc[0], bicycle_geometry(),
                                                              use_native=False))


def test_device_planner_falls_back_to_the_host_search(monkeypatch):
    """A device miss is planned by the host search and counted."""
    from mpc_for_av_at_intersection_tpu_torch import api

    sc = [free_area(goal_distance=15.0), intersection(turn_indicator=2, start_pos=3)]
    courses, stats = api.plan_courses_batch(sc, bicycle_geometry(), max_expansions=8,
                                            device="cpu")
    assert stats["n_device"] == 1 and stats["n_host_fallback"] == 1
    host = api.plan_course(sc[1], bicycle_geometry())
    np.testing.assert_array_equal(courses[1], host)
    assert courses[0].dtype == np.float64 and len(courses[0]) > 0
