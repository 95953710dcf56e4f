"""K4: the beam planner's frontier x primitive collision test.

``frontier_collision`` launches the CUDA kernel ``csrc/collision.cu`` for
CUDA tensors and runs ``frontier_collision_reference``'s plain PyTorch
version for CPU tensors. Replaces
``mpc_for_av_at_intersection_tpu/ops/collision_pallas.py``
(``frontier_collision`` -> ``_kernel``; packer ``pack_collision``).

What it computes, per scenario b, frontier pose f and primitive p: does
any collision point of p, placed at pose f, lie inside any live obstacle,
where inside means every half-plane row (a, b, c) of the obstacle has
a*x + b*y + c <= 0? Points are placed as (x + cos*px) - sin*py and
(y + sin*px) + cos*py; rows evaluate as (a*x + b*y) + c. Both versions take
the cosine and sine of the frontier headings from torch, computed once in
the wrapper, and the kernel is built without multiply-add contraction, so
a point on an obstacle's boundary falls on the same side in both.

The plain version is the JAX package's XLA broadcast over (F, P, C, O, 8);
it runs over a few scenarios at a time to bound its memory. ``rows_tested``
counts the half-plane rows each point needs in the kernel's loop: a point
reads a live obstacle's rows up to its first violated one (all 8 when
inside) and stops at its first obstacle hit. The kernel reads the live
obstacles' rows from a table ``pack_collision`` builds once per search
(``PackedCollision.live``, ``n_live``) and gives each lane of a warp
``points_per_lane`` consecutive points of one frontier pose.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

HH = 8              # half-plane rows per obstacle slot (compile_scenario's padding)
MAX_OBS = 64        # the kernel's shared-memory limits (csrc/collision.cu)
MAX_POINTS = 256
MAX_PRIMS = 32
LANES = 32          # a warp's lanes share one frontier pose's points
_PLAIN_CHUNK = 1 << 26   # elements of the plain version's (F, P, C, O, 8) broadcast per pass


class PackedCollision(NamedTuple):
    """One search's collision geometry on the device of its tensors."""

    cc: torch.Tensor        # (P*C, 2) float32 collision points, primitive-major
    cc_mask: torch.Tensor   # (P*C,) bool live points
    hp: torch.Tensor        # (B, O, 8, 3) float32 half-plane rows
    ov: torch.Tensor        # (B, O) bool live obstacles
    n_prims: int
    live: torch.Tensor      # (B, O, 8, 4) float32 rows (a, b, c, 0) of the live obstacles
    #                         in slot order, zero past n_live (the kernel's table)
    n_live: torch.Tensor    # (B,) int32 live obstacles


def points_per_lane(n_points: int) -> int:
    """Consecutive collision points each lane of the kernel holds: a warp
    covers one frontier pose's P*C points."""
    return -(-n_points // LANES)


def live_table(hp, ov):
    """(live, n_live): each scenario's live obstacles' rows, in slot order,
    as (a, b, c, 0), zero past the live count; hp (B, O, 8, 3), ov (B, O)."""
    B, O = ov.shape
    order = torch.argsort((~ov).to(torch.uint8), dim=1, stable=True)      # live slots first
    rows = torch.cat([hp, torch.zeros_like(hp[..., :1])], dim=-1)           # (B, O, 8, 4)
    live = torch.gather(rows, 1, order[:, :, None, None].expand(B, O, HH, 4))
    n_live = ov.sum(dim=1, dtype=torch.int32)
    keep = torch.arange(O, device=ov.device)[None, :] < n_live[:, None]
    return (live * keep[:, :, None, None]).contiguous(), n_live


def pack_collision(cc, cc_mask, halfplanes, obstacle_valid) -> PackedCollision:
    """cc (P, C, 2) and cc_mask (P, C) per-primitive collision points
    (numpy, ``prepare_primitives``); halfplanes (B, O, H<=8, 3) in the
    ``compile_scenario`` convention and obstacle_valid (B, O), tensors.
    Rows past H of a real obstacle are padded with [0, 0, -1] (always
    satisfied), as the JAX packer pads them."""
    hp = halfplanes.to(torch.float32)
    B, O, H, _ = hp.shape
    if H > HH:
        raise ValueError(f"{H} half-plane rows per obstacle > {HH}")
    if H < HH:
        fill = torch.tensor([0.0, 0.0, -1.0], device=hp.device).expand(B, O, HH - H, 3)
        hp = torch.cat([hp, fill], dim=2)
    P, C, _ = np.shape(cc)
    dev = hp.device
    ov = obstacle_valid.to(device=dev, dtype=torch.bool).contiguous()
    live, n_live = live_table(hp, ov)
    return PackedCollision(
        cc=torch.as_tensor(np.asarray(cc, np.float32).reshape(P * C, 2), device=dev),
        cc_mask=torch.as_tensor(np.asarray(cc_mask, bool).reshape(P * C), device=dev),
        hp=hp.contiguous(), ov=ov, n_prims=P, live=live, n_live=n_live)


def _row_values(ep, cos_sin, packed: PackedCollision, rows):
    """a*x + b*y + c of every half-plane row at every collision point of
    scenarios ``rows``: (b, F, P*C, O, 8)."""
    c, s = cos_sin[rows, :, 0:1], cos_sin[rows, :, 1:2]
    px, py = packed.cc[:, 0], packed.cc[:, 1]
    wx = ep[rows, :, 0:1] + c * px - s * py                         # (b, F, PC)
    wy = ep[rows, :, 1:2] + s * px + c * py
    hp = packed.hp[rows][:, None, None]                             # (b, 1, 1, O, 8, 3)
    return wx[..., None, None] * hp[..., 0] + wy[..., None, None] * hp[..., 1] + hp[..., 2]


def _chunks(ep, packed: PackedCollision):
    """Slices of scenarios whose broadcast holds at most _PLAIN_CHUNK values."""
    B, F, _ = ep.shape
    per_row = F * packed.cc.shape[0] * packed.hp.shape[1] * HH
    step = max(1, _PLAIN_CHUNK // max(per_row, 1))
    return [slice(lo, min(lo + step, B)) for lo in range(0, B, step)]


def _collide_plain(ep, cos_sin, packed: PackedCollision):
    B, F, _ = ep.shape
    out = torch.empty((B, F, packed.n_prims), dtype=torch.bool, device=ep.device)
    for rows in _chunks(ep, packed):
        inside = (_row_values(ep, cos_sin, packed, rows) <= 0.0).all(dim=-1)   # (b, F, PC, O)
        hit = inside & packed.ov[rows][:, None, None, :] & packed.cc_mask[:, None]
        out[rows] = hit.any(dim=-1).reshape(hit.shape[0], F, packed.n_prims, -1).any(dim=-1)
    return out


def _cos_sin(ep):
    return torch.stack([torch.cos(ep[..., 2]), torch.sin(ep[..., 2])], dim=-1).contiguous()


def frontier_collision_reference(ep, packed: PackedCollision):
    """Plain version: (B, F, P) bool for frontier poses ep (B, F, 3)."""
    return _collide_plain(ep, _cos_sin(ep), packed)


def rows_needed(ep, packed: PackedCollision):
    """Per chunk of scenarios ``rows``: (rows, need), need (b, F, P*C, O)
    int64 the half-plane rows each point reads of each obstacle under the
    kernel's early exits: up to its first violated row (all 8 when inside),
    none of a dead obstacle, past the point's first hit or for a masked
    point."""
    cs = _cos_sin(ep)
    for rows in _chunks(ep, packed):
        bad = ~(_row_values(ep, cs, packed, rows) <= 0.0)           # (b, F, PC, O, 8)
        inside = ~bad.any(dim=-1)
        n_read = torch.where(inside, HH, bad.to(torch.uint8).argmax(dim=-1) + 1)
        live = packed.ov[rows][:, None, None, :]
        hit = (inside & live).to(torch.int32)
        reached = (hit.cumsum(dim=-1) - hit) == 0                   # no hit before this obstacle
        yield rows, n_read * (live & reached) * packed.cc_mask[:, None]


def rows_tested(ep, packed: PackedCollision):
    """(B,) int64: the half-plane rows the points need for these poses,
    with the kernel's early exits (the work behind its bound)."""
    out = torch.zeros(ep.shape[0], dtype=torch.int64, device=ep.device)
    for rows, need in rows_needed(ep, packed):
        out[rows] = need.sum(dim=(1, 2, 3))
    return out


def frontier_collision(ep, packed: PackedCollision):
    """(B, F, P) bool: does candidate (frontier pose f, primitive p) of
    scenario b hit a live obstacle? ep (B, F, 3) float32 on the device of
    ``packed``."""
    if ep.device.type == "cpu":
        return _collide_plain(ep, _cos_sin(ep), packed)
    B, F, _ = ep.shape
    O = packed.hp.shape[1]
    PC = packed.cc.shape[0]
    P = packed.n_prims
    _build.check_cuda("ep", ep, (B, F, 3))
    _build.check_cuda("live", packed.live, (B, O, HH, 4))
    _build.check_cuda("n_live", packed.n_live, (B,), torch.int32)
    _build.check_cuda("cc", packed.cc, (PC, 2))
    _build.check_cuda("cc_mask", packed.cc_mask, (PC,), torch.bool)
    if len({t.device for t in (ep, packed.live, packed.n_live, packed.cc, packed.cc_mask)}) != 1:
        raise ValueError("frontier_collision: tensors on more than one device")
    if O > MAX_OBS or PC > MAX_POINTS or P > MAX_PRIMS or PC % P or B > 65535:
        raise ValueError(f"frontier_collision: B={B}, O={O}, P*C={PC}, P={P} beyond the "
                         f"kernel's limits (O <= {MAX_OBS}, P*C <= {MAX_POINTS}, "
                         f"P <= {MAX_PRIMS}, B <= 65535)")
    cs = _cos_sin(ep)
    out = torch.empty((B, F, P), dtype=torch.bool, device=ep.device)
    lib = _build.load()
    with torch.cuda.device(ep.device):
        err = lib.k4_frontier_collision(
            ep.data_ptr(), cs.data_ptr(), packed.live.data_ptr(), packed.n_live.data_ptr(),
            packed.cc.data_ptr(), packed.cc_mask.data_ptr(), out.data_ptr(), B, F, O, P,
            PC // P, points_per_lane(PC), _build.stream_handle(ep.device))
    _build.raise_on_error("K4 frontier_collision", err)
    frontier_collision.launches += 1
    return out


frontier_collision.launches = 0
