"""PyTorch port, K1 module: the QP build of the controller tick.

``build_qp_reference`` (the plain version of the CUDA kernel, and what
``build_qp`` runs on CPU tensors) is held to the JAX package's Pallas kernel
``build_qp_pallas`` in interpret mode and to its XLA rollout -> linearize ->
condense path, on the instance generator of ``tests/test_condense_pallas.py``
with its bar: atol 2e-6 * max(1, |ref|max) per field. The course
localization that feeds K1 (``compute_reference``) must match exactly.

Inputs are made with numpy and handed to JAX as explicit float32 (the test
session runs JAX with x64 enabled).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpc_for_av_at_intersection_tpu.core.dynamics import SimLimits as JaxSimLimits
from mpc_for_av_at_intersection_tpu.core.dynamics import plant_rollout as jax_plant_rollout
from mpc_for_av_at_intersection_tpu.mpc import MPCConfig as JaxMPCConfig
from mpc_for_av_at_intersection_tpu.mpc.condense import condense as jax_condense
from mpc_for_av_at_intersection_tpu.mpc.linearize import linearize_bicycle as jax_linearize
from mpc_for_av_at_intersection_tpu.mpc.reference import compute_reference as jax_compute_reference
from mpc_for_av_at_intersection_tpu.ops.condense_pallas import build_qp_pallas
from mpc_for_av_at_intersection_tpu_torch.core import smooth_yaw_numpy
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.mpc import MPCConfig
from mpc_for_av_at_intersection_tpu_torch.mpc.condense import CondensedQP
from mpc_for_av_at_intersection_tpu_torch.mpc.reference import compute_reference
from mpc_for_av_at_intersection_tpu_torch.ops.condense_qp import build_qp, build_qp_reference

torch.set_num_threads(2)

F32 = jnp.float32
WHEELBASE = bicycle_geometry().wheelbase


def _instances(T, B=130, seed=0):
    """The generator of tests/test_condense_pallas.py:23-31, in numpy."""
    rng = np.random.default_rng(seed)
    states = rng.normal(0, 3, (B, 4)).astype(np.float32)
    states[:, 2] = rng.uniform(0, 8, B)
    oa = rng.normal(0, 1, (B, T)).astype(np.float32)
    od = rng.normal(0, 0.2, (B, T)).astype(np.float32)
    xref = rng.normal(0, 3, (B, 4, T + 1)).astype(np.float32)
    re = rng.random((B, T + 1)) < 0.3
    return states, oa, od, xref, re


def _port_qp(T, inst):
    return build_qp_reference(*(torch.as_tensor(a) for a in inst), MPCConfig(T=T), WHEELBASE)


def _assert_fields_match(got: CondensedQP, ref):
    for name in CondensedQP._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert b.shape == a.shape, name
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=2e-6 * scale, err_msg=f"field {name}")


@pytest.mark.parametrize("T", [13, 20])
def test_build_qp_reference_matches_pallas_interpret(T):
    inst = _instances(T)
    states, oa, od, xref = (jnp.asarray(a, F32) for a in inst[:4])
    re = jnp.asarray(inst[4])
    ref = build_qp_pallas(states, oa, od, xref, re, JaxMPCConfig(T=T), WHEELBASE, interpret=True)
    _assert_fields_match(_port_qp(T, inst), ref)


@pytest.mark.parametrize("T", [13, 20])
def test_build_qp_reference_matches_xla_condense(T):
    cfg = JaxMPCConfig(T=T)
    limits = JaxSimLimits(max_steer=cfg.max_steer, max_speed=cfg.max_speed,
                          min_speed=cfg.min_speed)
    inst = _instances(T, seed=1)
    states, oa, od, xref = (jnp.asarray(a, F32) for a in inst[:4])
    re = jnp.asarray(inst[4])
    xbar = jax.vmap(lambda s, u: jax_plant_rollout(s, u, cfg.dt, WHEELBASE, limits))(
        states, jnp.stack([oa, od], axis=-1))
    A, B_, C = jax.vmap(lambda v, p, d: jax_linearize(v, p, d, cfg.dt, WHEELBASE))(
        xbar[:, :-1, 2], xbar[:, :-1, 3], jnp.zeros(oa.shape, F32))
    ref = jax.vmap(lambda a, b, c, s, r, e: jax_condense(a, b, c, s, r, e, cfg))(
        A, B_, C, states, xref, re)
    _assert_fields_match(_port_qp(T, inst), ref)


def test_build_qp_on_cpu_runs_the_plain_version():
    inst = _instances(13, B=6, seed=2)
    args = tuple(torch.as_tensor(a) for a in inst)
    got = build_qp(*args, MPCConfig(T=13), WHEELBASE)
    want = build_qp_reference(*args, MPCConfig(T=13), WHEELBASE)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _courses(rng, B, N, dl=0.083):
    """The course generator of tests/test_batched_solver.py:96-116."""
    turn = rng.normal(0, 0.01, size=(B, N)).cumsum(axis=1)
    yaw = rng.uniform(-np.pi, np.pi, size=(B, 1)) + turn
    xy = np.cumsum(np.stack([np.cos(yaw), np.sin(yaw)], axis=-1) * dl, axis=1)
    course = np.concatenate([xy, yaw[..., None]], axis=-1)
    for b in range(B):
        course[b, :, 2] = smooth_yaw_numpy(course[b, :, 2])
    return course.astype(np.float32)


@pytest.mark.parametrize("speed_ref", [False, True])
def test_compute_reference_matches_jax(speed_ref):
    """Localization, lookahead indexing (round half to even), the clamp to
    the course end and ``reaches_end``: exact on every row, including rows
    near the end of shortened courses and rows with a previous speed plan."""
    rng = np.random.default_rng(3)
    B, N, T, dt = 64, 200, 20, 0.2
    course = _courses(rng, B, N)
    speeds = rng.uniform(0, 8, (B, N)).astype(np.float32)
    valid = rng.integers(40, N + 1, size=B).astype(np.int32)
    dls = np.full(B, 0.083, np.float32)
    i0 = np.minimum(rng.integers(3, 200, size=B), valid - 2)
    states = np.stack([course[np.arange(B), i0, 0] + rng.normal(0, 0.2, B),
                       course[np.arange(B), i0, 1] + rng.normal(0, 0.2, B),
                       rng.uniform(0, 8, B),
                       course[np.arange(B), i0, 2] + rng.normal(0, 0.1, B)],
                      axis=1).astype(np.float32)
    start = np.maximum(i0 - 2, 0).astype(np.int32)
    ov = np.abs(rng.normal(4, 2, (B, T + 1))).astype(np.float32)
    have_ov = rng.random(B) < 0.5

    want = jax.vmap(lambda s, c, v, n, d, ti, o, h: jax_compute_reference(
        s, c, v, n, d, ti, o, h, T, dt, use_speed_channel=speed_ref))(
        jnp.asarray(states, F32), jnp.asarray(course, F32), jnp.asarray(speeds, F32),
        jnp.asarray(valid), jnp.asarray(dls, F32), jnp.asarray(start), jnp.asarray(ov, F32),
        jnp.asarray(have_ov))
    got = compute_reference(
        torch.as_tensor(states), torch.as_tensor(course), torch.as_tensor(speeds),
        torch.as_tensor(valid), torch.as_tensor(dls), torch.as_tensor(start),
        torch.as_tensor(ov), torch.as_tensor(have_ov), T, dt, use_speed_channel=speed_ref)
    assert got.target_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.xref.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.target_idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got.reaches_end.numpy(), np.asarray(want[2]))
    assert got.reaches_end.any() and not got.reaches_end.all()
