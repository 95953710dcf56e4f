"""K3: serial best-first A* lattice search, one search per scenario.

``astar_search_batch`` launches the CUDA kernel ``csrc/astar.cu`` for CUDA
tensors and runs ``astar_search_reference``, its plain PyTorch version, for
CPU tensors. Replaces ``mpc_for_av_at_intersection_tpu/ops/astar_pallas.py``
(``astar_search_batch`` -> ``_kernel``).

The search (the TPU kernel's, step for step): grid cells hold g, f and the
exact pose of their best node; each step pops the open cell of least f
(lowest cell index among equal f) and closes it; a pop inside the goal area
ends the search; otherwise the primitives are expanded from the exact pose,
collision-tested against the scenario's half-planes, and committed serially
over p = 0..P-1 where g improves by more than 1e-6. It stops on a goal pop,
an empty open set, or after ``max_expansions`` steps.

Both versions take the same inputs, prepared once by ``_prepare``: float32
tensors, the ``SearchWeights`` terms as scalars, and every float constant
rounded to float32 on the host, so that the kernel (built without
multiply-add contraction) rounds each step as the plain version does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

PP_SHIFT = 16       # parent/prim packing: pp = parent_cell * 16 + prim
HH = 8              # half-plane rows per obstacle slot
L1_MAX = 2048       # the kernel's level-1 entries (K3_L1_MAX): 16 KB of 64-bit keys
MIN_BLOCK = 128     # the least block: one cell per thread of a rescan
_F32 = np.float32
PI = float(_F32(np.pi))
TWO_PI = float(_F32(2.0 * np.pi))


class AStarKernelResult(NamedTuple):
    found: torch.Tensor        # (B,) bool
    cost: torch.Tensor         # (B,) float32, inf where not found
    goal_cell: torch.Tensor    # (B,) int32 — popped goal cell (backtrack entry)
    n_expansions: torch.Tensor  # (B,) int32
    oob: torch.Tensor          # (B,) int32 collision-free candidates off-grid
    parent: torch.Tensor       # (B, N) int32 parent cell per cell (-1 none)
    prim: torch.Tensor         # (B, N) int32 primitive id per cell (-1 none)
    rows_tested: torch.Tensor  # (B,) int64 half-plane rows the collision test
    #                            evaluated: a point stops at an obstacle's first
    #                            positive row and at its first obstacle hit


class _Inputs(NamedTuple):
    hp: torch.Tensor           # (B, O, 8, 3) float32
    hpn: torch.Tensor          # (B, O*8) norms of real rows of live obstacles, else 0
    ov: torch.Tensor           # (B, O) bool
    params: torch.Tensor       # (B, 11) start, goal, goal box, theta tol
    cc: torch.Tensor           # (P*C, 2) collision points
    cc_mask: torch.Tensor      # (P*C,) bool
    ends: torch.Tensor         # (P, 3)
    edge: torch.Tensor         # (P,) edge cost terms constant per primitive
    fconsts: tuple             # K3Consts order
    iconsts: tuple             # K3Ints order (max_exp and the level-1 block included)
    N: int


def level1_block(n_cells: int) -> int:
    """Cells per block of the kernel's min tree over the f grid: the least
    power of two >= MIN_BLOCK whose ceil(n_cells / block) level-1 keys fit
    L1_MAX, so that a rescan moves as few bytes as the shared-memory budget
    of level 1 allows."""
    blk = MIN_BLOCK
    while -(-n_cells // blk) > L1_MAX:
        blk *= 2
    return blk


def _wrap_pi(a):
    return torch.remainder(a + PI, TWO_PI) - PI


def _prepare(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol, prims, cfg, weights,
             max_expansions) -> _Inputs:
    dev = start.device
    f32 = torch.float32
    hp = halfplanes.to(f32)
    B, O, H, _ = hp.shape
    P, C, _ = prims.cc.shape
    if P >= PP_SHIFT:
        raise ValueError(f"primitive count {P} >= PP_SHIFT={PP_SHIFT}")
    if H > HH:
        raise ValueError(f"{H} half-plane rows per obstacle > {HH}")
    if H < HH:  # unused rows of a real obstacle: [0, 0, -1], always satisfied
        fill = torch.tensor([0.0, 0.0, -1.0], dtype=f32, device=dev).expand(B, O, HH - H, 3)
        hp = torch.cat([hp, fill], dim=2)
    hp = hp.contiguous()
    ov = obstacle_valid.to(torch.bool).contiguous()
    nrm = torch.hypot(hp[..., 0], hp[..., 1])
    hpn = torch.where((nrm > 1e-9) & ov[:, :, None], nrm, torch.zeros_like(nrm)).reshape(B, O * HH)
    params = torch.cat([start.to(f32), goal.to(f32), goal_box.to(f32),
                        theta_tol.to(f32).reshape(B, 1)], dim=1).contiguous()

    def host(a, dtype=f32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    ends = host(np.asarray(prims.ends, _F32))
    lengths = host(np.asarray(prims.lengths, _F32))
    edge = float(_F32(weights.c_dist)) * lengths
    if weights.c_steering:
        edge = edge + float(_F32(weights.c_steering)) * torch.abs(_wrap_pi(ends[:, 2]))
    use_edge_obs = bool(weights.c_obstacle) and (
        (not weights.gate_edge_obstacle_on_h) or bool(weights.h_obstacle))

    x0, y0, cell = _F32(cfg.x0), _F32(cfg.y0), _F32(cfg.cell)
    fconsts = tuple(float(v) for v in (
        x0, y0, cell, x0 + _F32(cfg.nx) * cell, y0 + _F32(cfg.ny) * cell,
        _F32(TWO_PI) / _F32(cfg.ntheta), _F32(PI), _F32(TWO_PI),
        _F32(weights.h_dist), _F32(weights.h_theta), _F32(weights.h_steering),
        _F32(weights.h_obstacle), _F32(weights.h_center), _F32(weights.c_obstacle),
        _F32(weights.c_center)))
    N = cfg.nx * cfg.ny * cfg.ntheta
    iconsts = (cfg.nx, cfg.ny, cfg.ntheta, int(weights.heuristic_mode == "area"),
               int(use_edge_obs), P, C, O, int(max_expansions), level1_block(N))
    return _Inputs(hp=hp, hpn=hpn.contiguous(), ov=ov, params=params,
                   cc=host(np.asarray(prims.cc, _F32).reshape(P * C, 2)),
                   cc_mask=host(np.asarray(prims.cc_mask, bool).reshape(P * C), torch.bool),
                   ends=ends, edge=edge.contiguous(), fconsts=fconsts, iconsts=iconsts, N=N)


def _unpack(pp, found, cost, goal_cell, n_exp, oob, rows_tested) -> AStarKernelResult:
    has = pp >= 0
    none = torch.full_like(pp, -1)
    return AStarKernelResult(
        found=found, cost=torch.where(found, cost, torch.full_like(cost, float("inf"))),
        goal_cell=goal_cell, n_expansions=n_exp, oob=oob,
        parent=torch.where(has, pp // PP_SHIFT, none),
        prim=torch.where(has, pp % PP_SHIFT, none), rows_tested=rows_tested)


class _Rows(NamedTuple):
    """Per-scenario search inputs shaped to broadcast against (B, lanes)."""

    gx: torch.Tensor
    gy: torch.Tensor
    gth: torch.Tensor
    ttol: torch.Tensor
    box: tuple                 # bx1, by1, bx2, by2, each (B, 1)
    a: torch.Tensor            # (B, O*8, 1) half-plane rows
    b: torch.Tensor
    c: torch.Tensor
    hpn: torch.Tensor          # (B, O*8, 1)
    ov: torch.Tensor           # (B, O)


def _rows(x: _Inputs) -> _Rows:
    pr = x.params
    hp = x.hp.reshape(pr.shape[0], -1, 3)
    return _Rows(gx=pr[:, 3:4], gy=pr[:, 4:5], gth=pr[:, 5:6], ttol=pr[:, 10:11],
                 box=tuple(pr[:, i:i + 1] for i in range(6, 10)),
                 a=hp[..., 0:1], b=hp[..., 1:2], c=hp[..., 2:3], hpn=x.hpn[..., None], ov=x.ov)


def _goal_box_dist(rw: _Rows, px, py):
    bx1, by1, bx2, by2 = rw.box
    dx = torch.maximum(torch.clamp(bx1 - px, min=0.0), px - bx2)
    dy = torch.maximum(torch.clamp(by1 - py, min=0.0), py - by2)
    return torch.sqrt(dx * dx + dy * dy)


def _obstacle_prox(rw: _Rows, px, py):
    """1 / (least distance to a half-plane boundary of a live obstacle);
    (B, L) points."""
    live = rw.hpn > 1e-9
    d = torch.abs(rw.a * px[:, None, :] + rw.b * py[:, None, :] + rw.c)
    d = torch.where(live, d / torch.where(live, rw.hpn, torch.ones_like(rw.hpn)), float("inf"))
    return 1.0 / torch.clamp(d.amin(dim=1), min=1e-9)


def _heuristic(x: _Inputs, rw: _Rows, px, py, th):
    (_, _, _, _, _, _, _, _, h_dist, h_theta, h_steering, h_obstacle, h_center, _, _) = x.fconsts
    adth = torch.abs(th - rw.gth)
    if x.iconsts[3]:  # goal-area mode
        h = _goal_box_dist(rw, px, py) + 2.7 * torch.clamp(adth - rw.ttol, min=0.0)
    else:
        dx, dy = px - rw.gx, py - rw.gy
        d = torch.sqrt(dx * dx + dy * dy)
        h = h_dist * d + h_theta * torch.minimum(adth, adth - rw.ttol / 2.0)
    if h_steering:
        h = h + h_steering * torch.abs(_wrap_pi(rw.gth - th))
    if h_obstacle:
        h = h + h_obstacle * _obstacle_prox(rw, px, py)
    if h_center:
        h = h + h_center * torch.sqrt(px * px + py * py)
    return h


def _cell_of(x: _Inputs, px, py, th):
    x0, y0, cell, _, _, bin_w = x.fconsts[:6]
    nx, ny, ntheta = x.iconsts[:3]
    i32 = torch.int32
    ix = torch.clamp(torch.floor((px - x0) / cell), 0, nx - 1).to(i32)
    iy = torch.clamp(torch.floor((py - y0) / cell), 0, ny - 1).to(i32)
    it = torch.clamp(torch.floor(torch.remainder(th + PI, TWO_PI) / bin_w), 0, ntheta - 1).to(i32)
    return ix * (ny * ntheta) + iy * ntheta + it


def astar_search_reference(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol, prims,
                           cfg, weights, max_expansions: int = 6144) -> AStarKernelResult:
    """Plain version of the kernel: the same search as batched tensor code,
    an argmin over the whole f grid per step (first index among ties) and a
    masked commit loop over the primitives."""
    return _search_plain(_prepare(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol,
                                  prims, cfg, weights, max_expansions))


def _search_plain(x: _Inputs) -> AStarKernelResult:
    """Every row takes every step, masked once it has stopped, so that no
    step waits on a data-dependent row count."""
    x0, y0, _, x_hi, y_hi = x.fconsts[:5]
    c_obstacle, c_center = x.fconsts[13:15]
    use_edge_obs, P, C, O, max_exp = x.iconsts[4:9]
    B, N = x.params.shape[0], x.N
    dev = x.params.device
    f32, i32 = torch.float32, torch.int32
    inf = float("inf")

    g = torch.full((B, N), inf, dtype=f32, device=dev)
    f = torch.full((B, N), inf, dtype=f32, device=dev)
    px = torch.zeros((B, N), dtype=f32, device=dev)
    py = torch.zeros_like(px)
    pth = torch.zeros_like(px)
    pp = torch.full((B, N), -1, dtype=i32, device=dev)
    rows = torch.arange(B, device=dev)
    rw = _rows(x)
    sx, sy, sth = x.params[:, 0:1], x.params[:, 1:2], x.params[:, 2:3]
    sc = _cell_of(x, sx, sy, sth)[:, 0].long()
    g[rows, sc] = 0.0
    f[rows, sc] = _heuristic(x, rw, sx, sy, sth)[:, 0]
    px[rows, sc], py[rows, sc], pth[rows, sc] = sx[:, 0], sy[:, 0], sth[:, 0]

    found = torch.zeros(B, dtype=torch.bool, device=dev)
    stop = torch.zeros_like(found)
    cost = torch.full((B,), inf, dtype=f32, device=dev)
    goal_cell = torch.full((B,), -1, dtype=i32, device=dev)
    n_exp = torch.zeros(B, dtype=i32, device=dev)
    oob = torch.zeros(B, dtype=i32, device=dev)
    rows_tested = torch.zeros(B, dtype=torch.int64, device=dev)
    ex, ey, et = x.ends[:, 0], x.ends[:, 1], x.ends[:, 2]
    ccx, ccy = x.cc[:, 0], x.cc[:, 1]

    for _ in range(max_exp):
        m, cell = f.min(dim=1)
        stop = stop | ~(m < inf)
        if bool(stop.all()):
            break
        run = ~stop
        gc, cx, cy, cth = g[rows, cell], px[rows, cell], py[rows, cell], pth[rows, cell]
        f[rows, cell] = torch.where(run, inf, f[rows, cell])  # close
        n_exp += run.to(i32)
        hit = run & (_goal_box_dist(rw, cx[:, None], cy[:, None])[:, 0] <= 1e-5) & (
            torch.abs(cth - rw.gth[:, 0]) <= rw.ttol[:, 0])
        found |= hit
        cost = torch.where(hit, gc, cost)
        goal_cell = torch.where(hit, cell.to(i32), goal_cell)
        stop = stop | hit
        expand = (run & ~hit)[:, None]

        cx, cy, cth, gc = cx[:, None], cy[:, None], cth[:, None], gc[:, None]
        cs, sn = torch.cos(cth), torch.sin(cth)
        cand_x = cx + cs * ex - sn * ey                                   # (B, P)
        cand_y = cy + sn * ex + cs * ey
        cand_t = _wrap_pi(et + cth)
        cand_g = gc + x.edge
        if use_edge_obs:
            cand_g = cand_g + c_obstacle * _obstacle_prox(rw, cand_x, cand_y)
        if c_center:
            cand_g = cand_g + c_center * torch.sqrt(cand_x * cand_x + cand_y * cand_y)

        # collision: every point against every live obstacle's rows
        wx = cx + cs * ccx - sn * ccy                                     # (B, P*C)
        wy = cy + sn * ccx + cs * ccy
        vals = rw.a * wx[:, None, :] + rw.b * wy[:, None, :] + rw.c      # (B, O*8, P*C)
        pos = (vals > 0.0).reshape(B, O, HH, -1)
        inside = ~pos.any(dim=2)                                          # (B, O, P*C)
        hit_o = inside & rw.ov[:, :, None]
        pt_hit = hit_o.any(dim=1) & x.cc_mask
        collide = pt_hit.reshape(B, P, C).any(dim=2)
        # the kernel's work: a point reads an obstacle's rows up to its
        # first positive one (all 8 when inside) and stops after its first hit
        n_read = torch.where(inside, HH, pos.to(torch.uint8).argmax(dim=2) + 1)
        reached = (hit_o.to(i32).cumsum(dim=1) - hit_o.to(i32)) == 0
        per_pt = (n_read * (rw.ov[:, :, None] & reached)).sum(dim=1) * x.cc_mask
        rows_tested += torch.where(expand[:, 0], per_pt.sum(dim=1), 0)

        inb = (cand_x >= x0) & (cand_x < x_hi) & (cand_y >= y0) & (cand_y < y_hi)
        oob += (expand & ~collide & ~inb).sum(dim=1).to(i32)
        valid = expand & ~collide & inb
        cand_f = cand_g + _heuristic(x, rw, cand_x, cand_y, cand_t)
        cand_cell = _cell_of(x, cand_x, cand_y, cand_t).long()
        parent = cell.to(i32) * PP_SHIFT

        # serial commit over the primitives: a later one sees an earlier
        # one's write to the same cell
        for p in range(P):
            k = cand_cell[:, p]
            old = g[rows, k]
            upd = valid[:, p] & (cand_g[:, p] < old - 1e-6)
            for grid, val in ((g, cand_g), (f, cand_f), (px, cand_x), (py, cand_y),
                              (pth, cand_t)):
                grid[rows, k] = torch.where(upd, val[:, p], grid[rows, k])
            pp[rows, k] = torch.where(upd, parent + p, pp[rows, k])

    return _unpack(pp, found, cost, goal_cell, n_exp, oob, rows_tested)


def astar_search_batch(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol, prims, cfg,
                       weights, max_expansions: int = 6144) -> AStarKernelResult:
    """B independent serial-A* searches: halfplanes (B, O, H<=8, 3),
    obstacle_valid (B, O), start/goal (B, 3), goal_box (B, 4), theta_tol
    (B,) as tensors on one device; prims a ``PrimitiveDeviceData`` (numpy),
    cfg the grid (``WavefrontConfig``), weights a ``SearchWeights``."""
    if start.device.type != "cpu":
        for name, t in (("halfplanes", halfplanes), ("obstacle_valid", obstacle_valid),
                        ("goal", goal), ("goal_box", goal_box), ("theta_tol", theta_tol)):
            if t.device != start.device:
                raise ValueError(f"{name}: expected a CUDA tensor on {start.device}, got {t.device}")
    x = _prepare(halfplanes, obstacle_valid, start, goal, goal_box, theta_tol, prims, cfg,
                 weights, max_expansions)
    if start.device.type == "cpu":
        return _search_plain(x)
    for name, t in (("hp", x.hp), ("hpn", x.hpn), ("params", x.params)):
        _build.check_cuda(name, t, t.shape)
    B, N = x.params.shape[0], x.N
    lib = _build.load()
    if (len(x.fconsts), len(x.iconsts)) != (lib.k3_num_floats(), lib.k3_num_ints()):
        raise RuntimeError("K3 constants do not match the kernel's K3Consts/K3Ints")
    dev = start.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    scratch = [empty((B, N)) for _ in range(5)]
    pp, cost, res = empty((B, N), torch.int32), empty((B,)), empty((B, 4), torch.int32)
    tested = empty((B,), torch.int64)
    with torch.cuda.device(dev):
        err = lib.k3_astar(
            x.hp.data_ptr(), x.hpn.data_ptr(), x.ov.data_ptr(), x.params.data_ptr(),
            x.cc.data_ptr(), x.cc_mask.data_ptr(), x.ends.data_ptr(), x.edge.data_ptr(), B, N,
            (ctypes.c_float * len(x.fconsts))(*x.fconsts), (ctypes.c_int * len(x.iconsts))(*x.iconsts),
            *(t.data_ptr() for t in scratch), pp.data_ptr(),
            cost.data_ptr(), res.data_ptr(), tested.data_ptr(), _build.stream_handle(dev))
    _build.raise_on_error("K3 astar_search", err)
    astar_search_batch.launches += 1
    del scratch
    return _unpack(pp, res[:, 0] > 0, cost, res[:, 1], res[:, 2], res[:, 3], tested)


astar_search_batch.launches = 0
