"""PyTorch port: the native C++ lattice search, built from the port's copy.

- ``native/lattice_search.cpp`` is a byte-for-byte copy of the JAX
  package's source.
- On four junctions (three weight presets) the port's native core returns
  the Python search's cost, path and trajectory exactly (both packages'
  Python searches are the same code), and the JAX package's native core's
  within 1e-9: the JAX library is built with ``-march=native`` and lets g++
  contract multiply-adds, the port's with ``-ffp-contract=off``.
- A 150k expansion budget on an unplannable junction raises
  ``NoPathError``, through the search and through ``api.plan_course``.
- Two processes that build into one empty directory at the same moment
  both load a whole library, and leave no temporary file behind.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mpc_for_av_at_intersection_tpu.lattice import MotionPrimitiveSearch as JaxSearch
from mpc_for_av_at_intersection_tpu.lattice import SearchWeights as JaxWeights
from mpc_for_av_at_intersection_tpu.lattice import primitive_table as jax_table
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu.worlds import t_intersection as jax_t_intersection
from mpc_for_av_at_intersection_tpu_torch import api
from mpc_for_av_at_intersection_tpu_torch.lattice import (
    MotionPrimitiveSearch,
    NoPathError,
    SearchWeights,
    primitive_table,
)
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.native import NativeMotionPrimitiveSearch, native_available
from mpc_for_av_at_intersection_tpu_torch.native import build as native_build
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection, roundabout, t_intersection

REPO = Path(__file__).resolve().parent.parent

CASES = {
    # name: (port scenario, JAX scenario, weights preset)
    "left_turn": (lambda: intersection(turn_indicator=1, start_pos=4),
                  lambda: jax_intersection(turn_indicator=1, start_pos=4), "modified"),
    "straight": (lambda: intersection(turn_indicator=2, start_pos=1),
                 lambda: jax_intersection(turn_indicator=2, start_pos=1), "modified"),
    "multi_lane": (lambda: intersection(turn_indicator=3, start_pos=2),
                   lambda: jax_intersection(turn_indicator=3, start_pos=2), "multi_lane"),
    "t_base": (lambda: t_intersection(turn_indicator=1, start_pos=1),
               lambda: jax_t_intersection(turn_indicator=1, start_pos=1), "base"),
}


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.skip("no g++: the native search cannot be built")


def test_cpp_source_is_a_byte_copy():
    ours = REPO / "mpc_for_av_at_intersection_tpu_torch" / "native" / "lattice_search.cpp"
    theirs = REPO / "mpc_for_av_at_intersection_tpu" / "native" / "lattice_search.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_native_matches_python_and_jax_native(native, name):
    from mpc_for_av_at_intersection_tpu.native import NativeMotionPrimitiveSearch as JaxNative
    from mpc_for_av_at_intersection_tpu.native import native_available as jax_native_available

    port_sc, jax_sc, wname = CASES[name]
    geom, table = bicycle_geometry(), primitive_table(bicycle_geometry())
    w = getattr(SearchWeights, wname)()
    cost, path, traj = NativeMotionPrimitiveSearch(port_sc(), geom, table, margin=geom.radius,
                                                   weights=w).run()
    py_cost, py_path, py_traj = MotionPrimitiveSearch(port_sc(), geom, table, margin=geom.radius,
                                                      weights=w).run()
    jgeom = jax_geometry()
    jw = getattr(JaxWeights, wname)()
    j_cost, j_path, j_traj = JaxSearch(jax_sc(), jgeom, jax_table(jgeom), margin=jgeom.radius,
                                       weights=jw).run()
    assert cost == py_cost == j_cost
    np.testing.assert_array_equal(np.asarray(path), np.asarray(py_path))
    np.testing.assert_array_equal(np.asarray(path), np.asarray(j_path))
    np.testing.assert_array_equal(traj, py_traj)
    np.testing.assert_array_equal(traj, j_traj)
    if jax_native_available():
        n_cost, n_path, n_traj = JaxNative(jax_sc(), jgeom, jax_table(jgeom), margin=jgeom.radius,
                                           weights=jw).run()
        assert cost == pytest.approx(n_cost, abs=1e-9)
        np.testing.assert_allclose(np.asarray(path), np.asarray(n_path), atol=1e-9, rtol=0)
        np.testing.assert_allclose(traj, n_traj, atol=1e-9, rtol=0)
    # the api entry point takes the native core and returns its trajectory
    np.testing.assert_array_equal(api.plan_course(port_sc(), geom, w), traj)


def test_budget_on_an_unplannable_junction_raises(native):
    """A sampled junction (seed 0's fourth draw: narrow road, wide corner)
    that the primitive set cannot turn through spends the whole budget."""
    geom = bicycle_geometry()
    sc = intersection(turn_indicator=3, start_pos=2, road=3.4049293003062666,
                      island=2.0762995539162534, corner_radius=7.452088346940576)
    search = NativeMotionPrimitiveSearch(sc, geom, primitive_table(geom), margin=geom.radius,
                                         max_expansions=150_000)
    with pytest.raises(NoPathError, match="budget"):
        search.run()
    with pytest.raises(NoPathError, match="budget"):
        api.plan_course(sc, geom, max_expansions=150_000)
    # an open set that empties is no-path too (the small roundabout's U-turn)
    with pytest.raises(NoPathError, match="no path"):
        api.plan_course(roundabout(turn_indicator=4, start_pos=1), geom, max_expansions=150_000)


_BUILD = """
import sys
from mpc_for_av_at_intersection_tpu_torch.native import build
import ctypes
path = build.build(sys.argv[1])
ctypes.CDLL(str(path)).lattice_search
print(path)
"""


def test_concurrent_builds_do_not_collide(native, tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.split()[-1] for out, _ in outs}
    assert paths == {str(native_build.library_path(tmp_path))}
    assert [f.name for f in tmp_path.iterdir()] == [Path(paths.pop()).name]
