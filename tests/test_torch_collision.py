"""PyTorch port: K4's packer and plain version against the JAX package.

On seeded frontier poses (float32, made with numpy) over two junctions and
``t_intersection``, as ``tests/test_collision_pallas.py`` builds them:

- ``pack_collision`` holds the JAX packer's collision points, half-plane
  rows (padded rows [0, 0, -1]), live-obstacle flags and point masks;
- ``frontier_collision_reference`` (and the wrapper on CPU tensors) gives
  masks exactly equal to the JAX Pallas kernel in interpret mode and to its
  XLA broadcast, per scenario and for the three scenarios as one batch;
- ``rows_tested`` equals a point-by-point count of the kernel's loop;
- the packer's live table (``PackedCollision.live``, ``n_live``) holds the
  live obstacles' rows of ``hp`` in slot order, whatever the live mask,
  and rows past H < 8 padded [0, 0, -1];
- an emulation of the kernel's loop order (a warp per frontier pose, each
  lane ``points_per_lane`` consecutive points, every row of the live table
  read once for all of a lane's points still inside the obstacle) gives
  the plain version's flags and ``rows_tested``'s count;
- a collision test that only the card runs refuses CPU tensors, and a
  CUDA-bound tensor is refused before anything is built or launched.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_for_av_at_intersection_tpu.lattice import primitive_table as jax_table
from mpc_for_av_at_intersection_tpu.lattice.wavefront import prepare_primitives as jax_prepare
from mpc_for_av_at_intersection_tpu.models import bicycle_geometry as jax_geometry
from mpc_for_av_at_intersection_tpu.ops import collision_pallas
from mpc_for_av_at_intersection_tpu.worlds import compile_scenario as jax_compile
from mpc_for_av_at_intersection_tpu.worlds import intersection as jax_intersection
from mpc_for_av_at_intersection_tpu.worlds import t_intersection as jax_t_intersection
from mpc_for_av_at_intersection_tpu_torch.lattice import primitive_table, prepare_primitives
from mpc_for_av_at_intersection_tpu_torch.lattice import wavefront
from mpc_for_av_at_intersection_tpu_torch.models import bicycle_geometry
from mpc_for_av_at_intersection_tpu_torch.ops import collision
from mpc_for_av_at_intersection_tpu_torch.worlds import compile_scenario, free_area
from mpc_for_av_at_intersection_tpu_torch.worlds import intersection, t_intersection

torch.set_num_threads(2)

SCENARIOS = {
    "left_turn": (lambda: intersection(turn_indicator=1, start_pos=4),
                  lambda: jax_intersection(turn_indicator=1, start_pos=4)),
    "straight": (lambda: intersection(turn_indicator=2, start_pos=1),
                 lambda: jax_intersection(turn_indicator=2, start_pos=1)),
    "t_junction": (lambda: t_intersection(turn_indicator=2, start_pos=4),
                   lambda: jax_t_intersection(turn_indicator=2, start_pos=4)),
}
F = 64


def _frontier_poses(start, n, seed):
    """``tests/test_collision_pallas.py::_frontier_poses``."""
    rng = np.random.default_rng(seed)
    ep = np.tile(np.asarray(start, np.float32), (n, 1))
    ep[:, 0] += rng.uniform(-20, 20, n)
    ep[:, 1] += rng.uniform(-20, 20, n)
    ep[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return ep.astype(np.float32)


def _jax_xla(ep, prims, hp, ov):
    """The JAX package's XLA broadcast (lattice/wavefront.py:341-353)."""
    c, s = jnp.cos(ep[:, 2]), jnp.sin(ep[:, 2])
    wx = (ep[:, None, None, 0] + c[:, None, None] * prims.cc[None, :, :, 0]
          - s[:, None, None] * prims.cc[None, :, :, 1])
    wy = (ep[:, None, None, 1] + s[:, None, None] * prims.cc[None, :, :, 0]
          + c[:, None, None] * prims.cc[None, :, :, 1])
    vals = (wx[:, :, :, None, None] * hp[None, None, None, :, :, 0]
            + wy[:, :, :, None, None] * hp[None, None, None, :, :, 1]
            + hp[None, None, None, :, :, 2])
    inside = jnp.all(vals <= 0.0, axis=-1)
    return jnp.any(inside & prims.cc_mask[None, :, :, None] & ov[None, None, None, :], axis=(2, 3))


@pytest.fixture(scope="module")
def cases():
    """Per scenario: port (poses, packed), JAX masks from the kernel and the
    broadcast, JAX packed geometry."""
    geom, jgeom = bicycle_geometry(), jax_geometry()
    prims = prepare_primitives(primitive_table(geom), geom)
    jprims = jax_prepare(jax_table(jgeom), jgeom, jnp.float32)
    out = {}
    for i, (name, (port_sc, jax_sc)) in enumerate(SCENARIOS.items()):
        arr = compile_scenario(port_sc(), margin=geom.radius)
        jarr = jax_compile(jax_sc(), margin=jgeom.radius)
        ep = _frontier_poses(arr.start, F, seed=i)
        jhp = jnp.asarray(jarr.halfplanes, jnp.float32)
        jov = jnp.asarray(jarr.obstacle_valid)
        jpacked = collision_pallas.pack_collision(jprims.cc, jprims.cc_mask, jhp, jov)
        jep = jnp.asarray(ep)
        want_kernel = np.asarray(collision_pallas.frontier_collision(jep, jpacked, interpret=True))
        want_xla = np.asarray(_jax_xla(jep, jprims, jhp, jov))
        packed = collision.pack_collision(
            prims.cc, prims.cc_mask, torch.as_tensor(arr.halfplanes, dtype=torch.float32)[None],
            torch.as_tensor(arr.obstacle_valid)[None])
        out[name] = (torch.as_tensor(ep)[None], packed, want_kernel, want_xla, jpacked, prims)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pack_collision_matches_the_jax_packer(cases, name):
    _, packed, _, _, jpacked, prims = cases[name]
    P, C, _ = prims.cc.shape
    O = packed.hp.shape[1]
    assert packed.n_prims == jpacked.n_prims == P
    np.testing.assert_array_equal(packed.cc[:, 0].numpy(), np.asarray(jpacked.ccx)[: P * C])
    np.testing.assert_array_equal(packed.cc[:, 1].numpy(), np.asarray(jpacked.ccy)[: P * C])
    rows = packed.hp[0].reshape(O * collision.HH, 3).numpy()
    for k, field in enumerate(("hpa", "hpb", "hpc")):
        np.testing.assert_array_equal(rows[:, k], np.asarray(getattr(jpacked, field))[: O * 8, 0])
    np.testing.assert_array_equal(packed.ov[0].numpy(), np.asarray(jpacked.valid_col)[:O, 0] > 0)
    gp = np.asarray(jpacked.gp)
    mask = np.stack([gp[p * C:(p + 1) * C, p] for p in range(P)]) > 0
    np.testing.assert_array_equal(packed.cc_mask.numpy().reshape(P, C), mask)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_plain_version_matches_the_jax_kernel_and_broadcast(cases, name):
    ep, packed, want_kernel, want_xla, _, _ = cases[name]
    np.testing.assert_array_equal(want_kernel, want_xla)
    got = collision.frontier_collision_reference(ep, packed)
    assert got.shape == (1, F, packed.n_prims) and got.dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), want_xla)
    # a random frontier gives both hits and misses
    assert 0 < int(got.sum()) < got.numel()
    before = collision.frontier_collision.launches
    np.testing.assert_array_equal(collision.frontier_collision(ep, packed)[0].numpy(), want_xla)
    assert collision.frontier_collision.launches == before


def test_one_batch_of_three_scenarios(cases, monkeypatch):
    """The three scenarios as one batch, run in chunks of one scenario and
    in one pass, equal the per-scenario JAX masks."""
    names = list(SCENARIOS)
    ep = torch.cat([cases[n][0] for n in names])
    first = cases[names[0]][1]
    packed = first._replace(hp=torch.cat([cases[n][1].hp for n in names]),
                            ov=torch.cat([cases[n][1].ov for n in names]))
    want = np.stack([cases[n][3] for n in names])
    np.testing.assert_array_equal(collision.frontier_collision_reference(ep, packed).numpy(), want)
    per_scenario = F * packed.cc.shape[0] * packed.hp.shape[1] * collision.HH
    monkeypatch.setattr(collision, "_PLAIN_CHUNK", per_scenario)
    assert len(collision._chunks(ep, packed)) == 3
    np.testing.assert_array_equal(collision.frontier_collision_reference(ep, packed).numpy(), want)


def test_rows_tested_counts_the_kernel_loop(cases):
    ep, packed, _, _, _, _ = cases["left_turn"]
    ep = ep[:, :6]
    got = collision.rows_tested(ep, packed)
    cs = torch.stack([torch.cos(ep[..., 2]), torch.sin(ep[..., 2])], -1)[0].numpy()
    pts, cmask = packed.cc.numpy(), packed.cc_mask.numpy()
    hp, ov = packed.hp[0].numpy(), packed.ov[0].numpy()
    want = 0
    for f in range(ep.shape[1]):
        x, y, _ = ep[0, f].numpy()
        c, s = cs[f]
        for i in np.flatnonzero(cmask):
            wx = (x + c * pts[i, 0]) - s * pts[i, 1]
            wy = (y + s * pts[i, 0]) + c * pts[i, 1]
            for o in np.flatnonzero(ov):
                inside = True
                for a, b, cc in hp[o]:
                    want += 1
                    if not (a * wx + b * wy) + cc <= np.float32(0.0):
                        inside = False
                        break
                if inside:
                    break
    assert int(got[0]) == want > 0


def test_the_kernel_refuses_what_it_does_not_take(cases):
    ep, packed, _, _, _, prims = cases["left_turn"]
    sc = [free_area(goal_distance=15.0)]
    before = collision.frontier_collision.launches
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.plan_courses_device(sc, bicycle_geometry(), engine="beam", collision="kernel",
                                      device="cpu")
    # ``meta`` tensors stand in for CUDA ones: refused before the build
    meta = packed._replace(hp=packed.hp.to("meta"), ov=packed.ov.to("meta"),
                           cc=packed.cc.to("meta"), cc_mask=packed.cc_mask.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        collision.frontier_collision(ep.to("meta"), meta)
    with pytest.raises(ValueError, match="half-plane rows"):
        collision.pack_collision(prims.cc, prims.cc_mask, torch.zeros(1, 4, 9, 3),
                                 torch.ones(1, 4, dtype=torch.bool))
    assert collision.frontier_collision.launches == before


@pytest.mark.parametrize("case", ["none_live", "all_live", "scattered", "short_rows"])
def test_live_table_holds_the_live_rows_in_slot_order(case):
    rng = np.random.default_rng(11)
    B, O, H = 4, 13, 5 if case == "short_rows" else 8
    hp = torch.as_tensor(rng.normal(0, 3, (B, O, H, 3)).astype(np.float32))
    ov = {"none_live": np.zeros((B, O), bool), "all_live": np.ones((B, O), bool)}.get(
        case, rng.random((B, O)) < 0.5)
    ov[0] = False                                   # one scenario with nothing live
    ov = torch.as_tensor(ov)
    prims = prepare_primitives(primitive_table(bicycle_geometry()), bicycle_geometry())
    packed = collision.pack_collision(prims.cc, prims.cc_mask, hp, ov)
    assert packed.live.shape == (B, O, collision.HH, 4) and packed.live.dtype == torch.float32
    assert packed.n_live.dtype == torch.int32
    np.testing.assert_array_equal(packed.n_live.numpy(), ov.sum(1).numpy())
    for b in range(B):
        slots = np.flatnonzero(ov[b].numpy())
        n = len(slots)
        want = packed.hp[b, slots].numpy()                      # (n, 8, 3), padded rows
        np.testing.assert_array_equal(packed.live[b, :n, :, :3].numpy(), want)
        assert not packed.live[b, :n, :, 3].any() and not packed.live[b, n:].any()
        if case == "short_rows" and n:
            np.testing.assert_array_equal(packed.live[b, :n, H:].numpy(),
                                          np.broadcast_to([0, 0, -1, 0], (n, 8 - H, 4)))


def _kernel_loop(ep, packed):
    """The kernel's loop order in numpy float32: a warp per pose, lane l
    holding points l*K .. l*K+K-1; per live obstacle of the table a lane
    reads each row once, for all its points still inside, until none is;
    a point inside all 8 rows hits and stops. Returns the (B, F, P) flags,
    the rows the points needed and the rows the lanes read."""
    B, F, _ = ep.shape
    PC, P = packed.cc.shape[0], packed.n_prims
    K = collision.points_per_lane(PC)
    C = PC // P
    pc = np.arange(collision.LANES * K).reshape(collision.LANES, K)
    valid = pc < PC
    valid[valid] = packed.cc_mask.numpy()[pc[valid]]
    pts = packed.cc.numpy()[np.minimum(pc, PC - 1)]                       # (32, K, 2)
    cs = collision._cos_sin(ep).numpy()
    live, n_live = packed.live.numpy(), packed.n_live.numpy()
    flags = np.zeros((B, F, P), bool)
    point_rows = lane_rows = 0
    for b in range(B):
        c, s = cs[b, :, 0, None, None], cs[b, :, 1, None, None]          # (F, 1, 1)
        ex, ey = ep[b, :, 0, None, None].numpy(), ep[b, :, 1, None, None].numpy()
        wx = (ex + c * pts[..., 0]) - s * pts[..., 1]                      # (F, 32, K)
        wy = (ey + s * pts[..., 0]) + c * pts[..., 1]
        alive = np.broadcast_to(valid, wx.shape).copy()
        for o in range(n_live[b]):
            inside = alive.copy()
            for r in range(collision.HH):
                a, bb, cc = live[b, o, r, :3]
                lane_rows += int(inside.any(-1).sum())
                point_rows += int(inside.sum())
                inside &= (a * wx + bb * wy) + cc <= np.float32(0.0)
            alive &= ~inside
            f, lane, q = np.nonzero(inside)
            flags[b, f, pc[lane, q] // C] = True
    return flags, point_rows, lane_rows


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_kernel_loop_order_gives_the_plain_flags_and_row_count(cases, name):
    ep, packed, _, want_xla, _, _ = cases[name]
    flags, point_rows, lane_rows = _kernel_loop(ep, packed)
    np.testing.assert_array_equal(flags[0], want_xla)
    assert point_rows == int(collision.rows_tested(ep, packed)[0])
    # one row read serves several points: fewer reads than point rows
    assert collision.points_per_lane(packed.cc.shape[0]) > 1 and lane_rows < point_rows
