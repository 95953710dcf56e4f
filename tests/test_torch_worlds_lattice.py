"""PyTorch port: the numpy copies of the worlds and the lattice, pinned to
the JAX package's originals.

The port carries its own copies of the numpy-only modules (it may import
nothing of the JAX package). Their code equals the originals' below the
module docstring, and they produce equal arrays: ``compile_scenario`` for
the 12 standard junctions, ``free_area`` and three sampled geometries, the
primitive tables, the grid configuration and the host search's cost on two
junctions (``MotionPrimitiveSearch`` directly: the JAX package's native
build races under xdist).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from mpc_for_av_at_intersection_tpu import lattice as jlattice
from mpc_for_av_at_intersection_tpu import worlds as jworlds
from mpc_for_av_at_intersection_tpu.lattice import wavefront as jwavefront
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu_torch import lattice, worlds
from mpc_for_av_at_intersection_tpu_torch.lattice import wavefront
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry

REPO = Path(__file__).resolve().parent.parent
JUNCTIONS = [(s, t) for s in (1, 2, 3, 4) for t in (1, 2, 3)]
SAMPLED = [(1, 2, 3.6, 1.5, 5.2), (3, 1, 4.9, 2.7, 7.1), (4, 3, 4.2, 2.1, 6.4)]


def _strip_docstring(source: str) -> str:
    tree = ast.parse(source)
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    return "\n".join(ast.unparse(node) for node in body)


@pytest.mark.parametrize("module", ["worlds/obstacles.py", "worlds/scenario.py", "worlds/envs.py",
                                    "lattice/primitives.py", "lattice/astar.py",
                                    "lattice/search.py"])
def test_numpy_copy_matches_the_original(module):
    ours = (REPO / "mpc_for_av_at_intersection_tpu_torch" / module).read_text()
    theirs = (REPO / "mpc_for_av_at_intersection_tpu" / module).read_text()
    assert _strip_docstring(ours) == _strip_docstring(theirs)


def _assert_arrays_equal(a, b):
    assert dataclasses.fields(a) and [f.name for f in dataclasses.fields(a)] == [
        f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def _pair(kind, args):
    if kind == "junction":
        s, t = args
        return (worlds.intersection(turn_indicator=t, start_pos=s),
                jworlds.intersection(turn_indicator=t, start_pos=s))
    if kind == "sampled":
        s, t, road, island, corner = args
        kw = dict(turn_indicator=t, start_pos=s, road=road, island=island, corner_radius=corner)
        return worlds.intersection(**kw), jworlds.intersection(**kw)
    return worlds.free_area(goal_distance=15.0), jworlds.free_area(goal_distance=15.0)


@pytest.mark.parametrize("kind,args", [("junction", j) for j in JUNCTIONS]
                         + [("sampled", g) for g in SAMPLED] + [("free_area", None)])
def test_compile_scenario_matches_jax(kind, args):
    ours, theirs = _pair(kind, args)
    margin = bicycle_geometry().radius
    _assert_arrays_equal(worlds.compile_scenario(ours, margin=margin),
                         jworlds.compile_scenario(theirs, margin=margin))


def test_stacked_arrays_and_grid_config_match_jax():
    from mpc_for_av_at_intersection_tpu.worlds.scenario import stack_scenario_arrays as jstack
    from mpc_for_av_at_intersection_tpu_torch.worlds.scenario import stack_scenario_arrays

    pairs = [_pair("junction", j) for j in JUNCTIONS] + [_pair("sampled", g) for g in SAMPLED]
    ours = [p[0] for p in pairs]
    theirs = [p[1] for p in pairs]
    margin = bicycle_geometry().radius
    _assert_arrays_equal(
        stack_scenario_arrays([worlds.compile_scenario(s, margin=margin) for s in ours]),
        jstack([jworlds.compile_scenario(s, margin=margin) for s in theirs]))
    for ntheta in (32, 40):
        a = wavefront.WavefrontConfig.for_scenarios(ours, ntheta=ntheta)
        b = jwavefront.WavefrontConfig.for_scenarios(theirs, ntheta=ntheta)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_cells == b.n_cells


def test_primitive_tables_match_jax():
    ours = lattice.primitive_table(bicycle_geometry())
    theirs = jlattice.primitive_table(jax_geometry())
    assert ours.names == theirs.names
    for name in ("steers", "points", "lengths"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    a = wavefront.prepare_primitives(ours, bicycle_geometry(), np.float32)
    b = jwavefront.prepare_primitives(theirs, jax_geometry(), np.float32)
    for name in a._fields:
        assert getattr(a, name).dtype == getattr(b, name).dtype, name
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("start,turn", [(1, 2), (4, 3)])
def test_host_search_matches_jax(start, turn):
    ours_sc, theirs_sc = _pair("junction", (start, turn))
    geom, jgeom = bicycle_geometry(), jax_geometry()
    ours = lattice.MotionPrimitiveSearch(ours_sc, geom, lattice.primitive_table(geom),
                                         margin=geom.radius).run()
    theirs = jlattice.MotionPrimitiveSearch(theirs_sc, jgeom, jlattice.primitive_table(jgeom),
                                            margin=jgeom.radius).run()
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[2], theirs[2])
