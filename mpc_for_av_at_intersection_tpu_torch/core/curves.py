"""Course localization on padded, batched curves.

Port of ``nearest_index`` and ``nearest_index_in_direction`` of
``mpc_for_av_at_intersection_tpu/core/curves.py`` (reference
``main/lib/trajectories.py:89-126``), with the batch written out as leading
axes: ``xy`` (..., 2), ``traj_xy`` (..., N, 2), ``start_idx`` and
``valid_len`` (...). Indices come back as int32.
"""

from __future__ import annotations

import torch

_BIG = 1e30


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
