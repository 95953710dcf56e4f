"""PyTorch port: the live loop, the plotting module and the grid-A* demo.

- ``run_episode_live`` with ``LiveView(save_dir=...)`` on the flagship with
  one scripted car at 6 ticks (``tests/test_engine.py``'s live test): its
  telemetry equals the port's ``run_episode`` exactly (the same tick on the
  same tensors), one frame a tick is written, and it equals JAX's
  ``run_episode_live`` within the bars of ``tests/test_torch_episode.py``
  (x, y within 2e-4, steer within 5e-4, flags exact). A callback sees host
  numpy, and the loop stops at the goal.
- ``primitive_fanout_trajectories`` equals JAX's within 1e-6 (float32 sines,
  cosines and tangents of two libraries), at three levels and at one wide fan.
- ``utils/plotting.py`` and ``utils/grid_astar_demo.py`` are copies of the
  JAX package's below their docstrings (plotting less the fan-out, which
  rolls on torch, and its import of the default device); every plotting
  function draws the port's telemetry turned numpy; ``grid_astar`` gives
  the JAX demo's path and expansion order, and both boards render alike.
"""

import ast
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu.agents import make_t_intersection_agent as jax_agent
from mpc_for_av_at_intersection_tpu.agents import stack_agents as jax_stack_agents
from mpc_for_av_at_intersection_tpu.engine import EngineConfig as JaxEngineConfig
from mpc_for_av_at_intersection_tpu.engine import init_engine_state as jax_init_state
from mpc_for_av_at_intersection_tpu.engine import make_world as jax_make_world
from mpc_for_av_at_intersection_tpu.engine import run_episode_live as jax_run_episode_live
from mpc_for_av_at_intersection_tpu.lattice import MotionPrimitiveSearch as JaxSearch
from mpc_for_av_at_intersection_tpu.lattice import primitive_table as jax_primitive_table
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.utils import grid_astar_demo as jdemo
from mpc_for_av_at_intersection_tpu.utils import plotting as jplotting
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.agents import make_t_intersection_agent, stack_agents
from mpc_for_av_at_intersection_tpu_torch.engine import (
    EngineConfig,
    init_engine_state,
    make_world,
    run_episode,
    run_episode_live,
)
from mpc_for_av_at_intersection_tpu_torch.engine.closed_loop import tree_map
from mpc_for_av_at_intersection_tpu_torch.lattice import MotionPrimitiveSearch, primitive_table
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.utils import grid_astar_demo, plotting
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N_LIVE = 6


def _body(path, skip=()):
    """The module's code below its docstring, less the named top-level
    functions and the imports of the named names."""
    tree = ast.parse(Path(path).read_text())
    out = []
    for node in tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in skip:
            continue
        if isinstance(node, ast.ImportFrom) and {a.name for a in node.names} <= set(skip):
            continue
        out.append(ast.unparse(node))
    return out


@pytest.mark.parametrize("module,skip", [
    ("utils/plotting.py", ("primitive_fanout_trajectories", "CUDA")),
    ("utils/grid_astar_demo.py", ()),
])
def test_copy_matches_the_original(module, skip):
    ours = _body(REPO / "mpc_for_av_at_intersection_tpu_torch" / module, skip)
    theirs = _body(REPO / "mpc_for_av_at_intersection_tpu" / module, skip)
    assert ours == theirs


@pytest.fixture(scope="module")
def flagship_course():
    """The flagship course, planned once by the Python search (the JAX
    package's native build races under xdist)."""
    geom = jax_geometry()
    search = JaxSearch(jax_intersection(turn_indicator=1, start_pos=4), geom,
                       jax_primitive_table(geom), margin=geom.radius)
    _, _, trajectory = search.run()
    return trajectory


def test_live_episode_matches_run_episode_and_jax(flagship_course, tmp_path):
    trajectory = flagship_course
    geom, cfg = bicycle_geometry(), EngineConfig()
    row = dict(direction=1, turning=False, speed=25 / 3.6, offset=2.0)
    params, ag = stack_agents([make_t_intersection_agent(**row)], n_slots=cfg.n_agents)
    world = make_world(trajectory, params, cfg, device="cpu")
    st0 = init_engine_state(world, ag, cfg, N_LIVE, device="cpu")

    _, tel_s = run_episode(world, st0, cfg, geom, N_LIVE)
    view = plotting.LiveView(intersection(turn_indicator=1, start_pos=4), geom,
                             trajectory=trajectory, save_dir=str(tmp_path / "frames"))
    seen = []

    def on_tick(k, st, tel, agents6):
        assert isinstance(st.ego, np.ndarray) and isinstance(tel.x, np.ndarray)
        assert agents6.shape == (cfg.n_agents, 6)
        seen.append(k)
        view(k, st, tel, agents6)

    final_l, tel_l = run_episode_live(world, st0, cfg, geom, N_LIVE, on_tick=on_tick)
    view.close()
    assert seen == list(range(N_LIVE)) and int(final_l.tick) == N_LIVE
    for name in tel_l._fields:
        np.testing.assert_array_equal(getattr(tel_l, name), getattr(tel_s, name).numpy(),
                                      err_msg=name)
    frames = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(frames) == N_LIVE

    jcfg = JaxEngineConfig()
    jparams, jag = jax_stack_agents([jax_agent(**row)], n_slots=jcfg.n_agents)
    jworld = jax_make_world(trajectory, jparams, jcfg)
    _, tel_j = jax_run_episode_live(jworld, jax_init_state(jworld, jag, jcfg, N_LIVE), jcfg,
                                    jax_geometry(), N_LIVE)
    assert len(tel_j.x) == N_LIVE
    for name, tol in (("x", 2e-4), ("y", 2e-4), ("yaw", 2e-4), ("v", 2e-4), ("steer", 5e-4)):
        np.testing.assert_allclose(getattr(tel_l, name), np.asarray(getattr(tel_j, name)),
                                   atol=tol, rtol=0, err_msg=name)
    for name in ("solved", "collision_found", "cutoff_len", "done"):
        np.testing.assert_array_equal(getattr(tel_l, name), np.asarray(getattr(tel_j, name)),
                                      err_msg=name)


def test_live_episode_stops_at_the_goal():
    setup = api.build_intersection(other_vehicles=False, n_steps=80, device="cpu")
    final, tel = run_episode_live(setup.world, setup.state0, setup.cfg, setup.geom, 80)
    k = int(final.ticks_to_goal)
    assert bool(final.done) and k < 79
    assert tel.x.shape == (k + 1,) and tel.done[-1] and not tel.done[:-1].any()


@pytest.mark.parametrize("kw", [dict(levels=3), dict(levels=1, num_mps=9, mp_time=2.0)])
def test_primitive_fanout_matches_jax(kw):
    got = plotting.primitive_fanout_trajectories(device="cpu", **kw)
    want = jplotting.primitive_fanout_trajectories(**kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)


def test_plotting_draws_port_telemetry(tmp_path):
    geom = bicycle_geometry()
    sc = intersection(turn_indicator=1, start_pos=4)
    search = MotionPrimitiveSearch(sc, geom, primitive_table(geom), margin=geom.radius)
    _, _, traj = search.run(debug=True)
    setup = api.build_intersection(other_vehicles=False, n_steps=12, device="cpu")
    _, tel = run_episode(setup.world, setup.state0, setup.cfg, setup.geom, 12)
    tel = tree_map(lambda t: t.numpy(), tel)

    fig, ax = plt.subplots()
    plotting.draw_scenario(sc, ax, show_hidden=True)
    plotting.draw_car((0.0, 0.0, 0.5), geom, ax, steer=0.2, draw_circles=True)
    assert plotting.draw_search_points(search, ax) is not None
    fig.savefig(tmp_path / "scenario.png")
    axes = plotting.plot_telemetry(tel)
    axes[0].figure.savefig(tmp_path / "telemetry.png")
    fig2, ax2 = plt.subplots()
    plotting.plot_trajectories(tel, ax2)
    inside = plotting.plot_halfplane_region(np.array([[1.0, 0.0, -5.0], [0.0, 1.0, -5.0]]),
                                            ax2, res=50)
    assert inside.shape == (50, 50) and inside.any() and not inside.all()
    anim = plotting.animate_episode(sc, geom, tel)
    anim._draw_frame(3)
    ax3 = plotting.plot_primitive_fanout(levels=2, device="cpu")
    assert len(ax3.get_lines()) == 5 + 25
    rec = type("Rec", (), dict(param="w_perp", value=1.0, ticks_to_goal=0, telemetry=tel))
    fig4, axes4 = plotting.overlay_telemetry([rec], trajectory=traj, scenario=sc)
    assert "w_perp=1" in [ln.get_label() for ln in axes4[1].get_lines()]
    plt.close("all")
    assert (tmp_path / "scenario.png").stat().st_size > 1000


def test_grid_astar_matches_jax(tmp_path, capsys):
    start, goal = (2, 2), (20, 21)
    wall = [(r, 12) for r in range(3, 22)]
    path, explored = grid_astar_demo.grid_astar(start, goal, wall)
    jpath, jexplored = jdemo.grid_astar(start, goal, wall)
    assert path == jpath and explored == jexplored and path[0] == start and path[-1] == goal
    assert grid_astar_demo.render_ascii(start, goal, wall, path, explored) == jdemo.render_ascii(
        start, goal, wall, jpath, jexplored)
    ax, p2, _ = grid_astar_demo.plot_grid_astar(start, goal, wall)
    assert p2 == path
    ax.figure.savefig(tmp_path / "grid.png")
    plt.close("all")
    grid_astar_demo.main()
    assert f"path length {len(path)}, {len(explored)} cells expanded" in capsys.readouterr().out
    with pytest.raises(grid_astar_demo.NoPathError):
        grid_astar_demo.grid_astar((0, 0), (5, 5), [(r, 3) for r in range(25)])
