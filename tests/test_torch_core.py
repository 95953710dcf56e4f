"""PyTorch port, core layer: plant, angles and course localization against
the JAX package on the cases of ``tests/test_core.py``.

Inputs are made with numpy and handed to JAX as explicit float32 (the test
session runs JAX with x64 enabled). Bars: float32 atol 1e-6; indices exact.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpc_for_av_at_intersection_tpu.core import angles as jax_angles
from mpc_for_av_at_intersection_tpu.core import curves as jax_curves
from mpc_for_av_at_intersection_tpu.core import dynamics as jax_dyn
from mpc_for_av_at_intersection_tpu_torch.core import (
    SimLimits,
    nearest_index,
    nearest_index_in_direction,
    normalize_angle,
    plant_rollout,
    plant_step,
    smooth_yaw,
    smooth_yaw_numpy,
)
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry

from oracles import ref_numpy

torch.set_num_threads(2)

F32 = jnp.float32
ATOL = 1e-6
WHEELBASE = bicycle_geometry().wheelbase


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_plant_step_matches_jax():
    lim = SimLimits()
    jlim = jax_dyn.SimLimits()
    rng = np.random.default_rng(0)
    # the test_core clamp/ordering case plus random states and controls
    states = np.concatenate([[[0.0, 0.0, 8.0, 0.3]], rng.normal(0, 3, (63, 4))]).astype(np.float32)
    controls = np.concatenate([[[3.0, 1.2]], rng.normal(0, 1, (63, 2))]).astype(np.float32)
    want = np.asarray(jax.vmap(lambda s, u: jax_dyn.plant_step(s, u, 0.2, WHEELBASE, jlim))(
        jnp.asarray(states, F32), jnp.asarray(controls, F32)))
    got = plant_step(_t(states), _t(controls), 0.2, WHEELBASE, lim).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0, 2] == pytest.approx(lim.max_speed)


def test_plant_rollout_matches_jax():
    lim = SimLimits()
    jlim = jax_dyn.SimLimits()
    rng = np.random.default_rng(2)
    B, T = 16, 13
    controls = rng.normal(0.0, 1.0, size=(B, T, 2)).astype(np.float32)
    states = rng.normal(0.0, 2.0, size=(B, 4)).astype(np.float32)
    states[0] = [1.0, -2.0, 3.0, 0.5]
    want = np.asarray(jax.vmap(lambda s, u: jax_dyn.plant_rollout(s, u, 0.2, WHEELBASE, jlim))(
        jnp.asarray(states, F32), jnp.asarray(controls, F32)))
    got = plant_rollout(_t(states), _t(controls), 0.2, WHEELBASE, lim).numpy()
    assert got.shape == (B, T + 1, 4)
    np.testing.assert_allclose(got, want, atol=ATOL * 10, rtol=1e-6)
    # the port's unbatched call takes the same (T, 2) layout as the JAX one
    one = plant_rollout(_t(states[0]), _t(controls[0]), 0.2, WHEELBASE, lim).numpy()
    np.testing.assert_array_equal(one, got[0])


def test_normalize_angle_matches_jax():
    thetas = np.linspace(-12.0, 12.0, 301).astype(np.float32)
    want = np.asarray(jax_angles.normalize_angle(jnp.asarray(thetas, F32)))
    got = normalize_angle(_t(thetas)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got >= -math.pi) and np.all(got < math.pi)


def test_smooth_yaw_matches_jax():
    rng = np.random.default_rng(0)
    steps = rng.normal(0.0, 0.15, size=200).cumsum() + 2.5
    course_yaw = np.array([ref_numpy.normalize_angle(t) for t in steps], np.float32)
    jumps = np.array([0.0, 0.6 * math.pi, -0.9 * math.pi, 3.0, -3.0, 2.9, -2.9], np.float32)
    for yaw in (course_yaw, jumps):
        want = np.asarray(jax_angles.smooth_yaw(jnp.asarray(yaw, F32)))
        got = smooth_yaw(_t(yaw)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
    # batched along leading axes, with padding carried through unchanged
    yaw = np.stack([course_yaw[:7], jumps])
    valid = np.arange(7)[None, :] < np.array([[7], [4]])
    got = smooth_yaw(_t(yaw), torch.as_tensor(valid)).numpy()
    for b in range(2):
        want = np.asarray(jax_angles.smooth_yaw(jnp.asarray(yaw[b], F32), jnp.asarray(valid[b])))
        np.testing.assert_allclose(got[b], want, atol=ATOL)


def test_smooth_yaw_numpy_is_the_jax_one():
    rng = np.random.default_rng(5)
    yaw = rng.uniform(-np.pi, np.pi, 300) + rng.normal(0, 0.01, 300).cumsum()
    np.testing.assert_array_equal(smooth_yaw_numpy(yaw), jax_angles.smooth_yaw_numpy(yaw))


def _random_curve(rng, n):
    steps = rng.uniform(0.02, 0.15, size=(n, 2))
    return np.concatenate([steps.cumsum(axis=0), rng.normal(size=(n, 1))], axis=1)


def test_nearest_index_matches_jax():
    traj = np.stack([np.linspace(0, 10, 101), np.zeros(101)], axis=1).astype(np.float32)
    xy = np.array([3.26, 0.5], np.float32)
    for start in (0, 50):
        want = int(jax_curves.nearest_index(jnp.asarray(xy, F32), jnp.asarray(traj, F32), start))
        got = int(nearest_index(_t(xy), _t(traj), start))
        assert got == want
    assert int(nearest_index(_t(xy), _t(traj))) == 33


def test_nearest_index_in_direction_matches_jax():
    """The 200 trials of test_core (including those where the reference
    raises and both fall back to the nearest index), batched in one call."""
    rng = np.random.default_rng(6)
    pts = _random_curve(rng, 80)[:, :2].astype(np.float32)
    xys, starts = [], []
    for _ in range(200):
        i = rng.integers(0, 78)
        xys.append(pts[i] + rng.normal(0, 0.05, size=2))
        starts.append(int(rng.integers(0, min(i + 1, 75))))
    xys = np.asarray(xys, np.float32)
    starts = np.asarray(starts, np.int32)
    valid = np.full(200, len(pts), np.int32)
    want = np.asarray(jax.vmap(
        lambda xy, s, n: jax_curves.nearest_index_in_direction(xy, jnp.asarray(pts, F32), s, n)
    )(jnp.asarray(xys, F32), jnp.asarray(starts), jnp.asarray(valid)))
    got = nearest_index_in_direction(
        _t(xys), _t(pts).expand(200, -1, -1), _t(starts, torch.int32), _t(valid, torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start,valid_len", [(1, 3), (2, 3), (3, 3), (0, 2), (0, 3)])
def test_nearest_index_in_direction_degenerate_windows(start, valid_len):
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]], np.float32)
    xy = np.array([0.1, 0.0], np.float32)
    want = int(jax_curves.nearest_index_in_direction(
        jnp.asarray(xy, F32), jnp.asarray(pts, F32), start, valid_len))
    got = int(nearest_index_in_direction(_t(xy), _t(pts), start, valid_len))
    assert got == want
