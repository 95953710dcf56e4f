"""Course localization and decimation on padded, batched curves.

Port of ``mpc_for_av_at_intersection_tpu/core/curves.py`` (reference
``main/lib/trajectories.py:58-126``), with the batch written out as leading
axes: ``xy`` (..., 2), ``traj_xy`` (..., N, 2), ``start_idx`` and
``valid_len`` (...). Indices come back as int32.
"""

from __future__ import annotations

import torch

_BIG = 1e30
_SCAN_BLOCK = 16


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[b]`` of each curve: t (B, N, D), idx (B,) -> (B, D)."""
    return torch.gather(t, 1, idx.to(torch.int64)[:, None, None].expand(-1, 1, t.shape[2]))[:, 0]


def cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis in XLA's CPU summation order:
    sequential inside blocks of 16, the block totals scanned the same way
    (recursively) and added on. ``torch.cumsum`` accumulates float32 in
    float64 on the CPU and scans in parallel on the card, so its last bits
    differ; the arc-length decimation below floors these sums, and an ulp
    there keeps another course point."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros(x.shape[:-1] + (nb * _SCAN_BLOCK - n,))
    blocks = torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nb, _SCAN_BLOCK))
    inner = cumsum_blocked(blocks)
    outer = cumsum_blocked(inner[..., -1])
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]], dim=-1)
    out = (inner + excl[..., None]).reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))
    return out[..., :n]


def arc_positions(points_xy, valid_mask=None):
    """Cumulative arc length per point: points_xy (..., N, 2) -> (..., N),
    segments past ``valid_mask`` (..., N) counted as 0."""
    d = points_xy[..., 1:, :] - points_xy[..., :-1, :]
    seg = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    seg = torch.cat([torch.zeros_like(seg[..., :1]), seg], dim=-1)
    if valid_mask is not None:
        seg = torch.where(valid_mask, seg, torch.zeros_like(seg))
    return cumsum_blocked(seg)


def resample_mask(points, dl, valid_mask, keep_last: bool = True):
    """Keep-mask for arc-length decimation of padded curves (reference
    ``resample_curve``): a point is kept where the integer part of
    (cumulative arc length / dl) steps up; the first point always, the last
    valid one when ``keep_last``. points (..., N, >=2); dl scalar or
    (..., N); valid_mask (..., N) bool."""
    xy = points[..., :2]
    d = xy[..., 1:, :] - xy[..., :-1, :]
    seg = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    seg = torch.cat([torch.zeros_like(seg[..., :1]), seg], dim=-1)
    seg = torch.where(valid_mask, seg, torch.zeros_like(seg))
    q = torch.floor(cumsum_blocked(seg) / dl)
    step_up = (q[..., 1:] - q[..., :-1]) >= 1.0
    mask = torch.cat([torch.ones_like(step_up[..., :1]), step_up], dim=-1)
    if keep_last:
        last = torch.clamp(valid_mask.sum(-1) - 1, min=0)
        mask = mask.scatter(-1, last[..., None], True)
    return mask & valid_mask


def compact_by_mask(points, mask, out_len: int):
    """Move the kept rows of ``points`` (B, N, D) to the front of an
    (B, out_len, D) buffer whose tail repeats the last kept row (reference
    ``collision_avoidance.py:18-22``). Each output row is one input row,
    copied by index. Returns (out, n_kept int32 (B,))."""
    B, n = mask.shape
    D = points.shape[2]
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    n_kept = mask.sum(-1)
    # dropped rows all go to a spare slot past the end, which is cut off
    dest = torch.where(mask & (pos < out_len), pos, torch.full_like(pos, out_len))
    out = points.new_zeros((B, out_len + 1, D))
    out.scatter_(1, dest[..., None].expand(B, n, D), points)
    out = out[:, :out_len]
    last_idx = (n - 1) - torch.argmax(mask.flip(-1).to(torch.uint8), dim=-1)
    last_idx = torch.where(n_kept > 0, last_idx, torch.zeros_like(last_idx))
    last_row = take_rows(points, last_idx)
    fill = torch.arange(out_len, device=points.device)[None, :, None] >= n_kept[:, None, None]
    out = torch.where(fill, last_row[:, None], out)
    return out, n_kept.to(torch.int32)


def _masked_sq_dist(xy, traj_xy, start_idx, valid_len):
    idx = torch.arange(traj_xy.shape[-2], device=traj_xy.device)
    d2 = torch.sum((traj_xy - xy[..., None, :]) ** 2, dim=-1)
    in_range = (idx >= start_idx[..., None]) & (idx < valid_len[..., None])
    return torch.where(in_range, d2, torch.full_like(d2, _BIG))


def _as_index(v, like):
    return torch.as_tensor(v, device=like.device).expand(like.shape[:-2])


def nearest_index(xy, traj_xy, start_idx=0, valid_len=None):
    """Index of the nearest trajectory point at or after ``start_idx``."""
    if valid_len is None:
        valid_len = traj_xy.shape[-2]
    d2 = _masked_sq_dist(xy, traj_xy, _as_index(start_idx, traj_xy),
                         _as_index(valid_len, traj_xy))
    return torch.argmin(d2, dim=-1).to(torch.int32)


def nearest_index_in_direction(xy, traj_xy, start_idx, valid_len, forward: bool = True):
    """Directional nearest index (reference ``trajectories.py:100-126``).

    Finds the 3 nearest points after ``start_idx`` ordered by distance
    (i0, i1, i2). If i1 and i2 straddle i0 (|i1-i2| == 2) the answer is i0;
    else if i1 is adjacent to i0, the answer is max(i0, i1) moving forward
    (min backward). Windows of 2 or fewer points reduce to the reference's
    special cases. Where the reference raises ("something wrong", :120) the
    answer is i0, the plain nearest index.
    """
    start_idx = _as_index(start_idx, traj_xy).to(torch.int64)
    valid_len = _as_index(valid_len, traj_xy).to(torch.int64)
    d2 = _masked_sq_dist(xy, traj_xy, start_idx, valid_len)
    n_avail = torch.clamp(valid_len - start_idx, min=0)

    i0 = torch.argmin(d2, dim=-1, keepdim=True)
    d2 = d2.scatter(-1, i0, _BIG)
    i1 = torch.argmin(d2, dim=-1, keepdim=True)
    d2 = d2.scatter(-1, i1, _BIG)
    i2 = torch.argmin(d2, dim=-1)
    i0, i1 = i0[..., 0], i1[..., 0]

    straddle = torch.abs(i1 - i2) == 2
    adjacent = torch.abs(i0 - i1) == 1
    pick_adj = torch.maximum(i0, i1) if forward else torch.minimum(i0, i1)
    res3 = torch.where(straddle, i0, torch.where(adjacent, pick_adj, i0))
    res2 = start_idx + 1 if forward else start_idx
    out = torch.where(n_avail >= 3, res3,
                      torch.where(n_avail == 2, res2, start_idx))
    return out.to(torch.int32)
