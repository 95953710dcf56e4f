"""Frame-windowed conflict detection + reference-trajectory cutoff, batched.

Port of ``mpc_for_av_at_intersection_tpu/agents/collision.py`` (reference
``main/lib/collision_avoidance.py``), with the scenario batch as the
leading axis:

1. every obstacle prediction is time-shifted by every offset in
   [-frame_window, +frame_window];
2. ego and obstacle collision-circle centers are compared frame-aligned
   over n_iter = max(len(ego), len(pred)) frames, trajectories padded by
   repeating their last pose (phantom tail frames DO count, :18-29);
3. the FIRST hit in (frame, ego-circle, obstacle, shift, obstacle-circle)
   lexicographic order picks the colliding obstacle-circle position (:81);
4. that position is re-localized on the detailed path by scanning circle
   trajectories circle-major and taking argmax % path_len (:92-98).

The JAX package expands the per-prediction-frame circle points to the
(shift, frame) table with a one-hot matmul (a TPU layout choice); here it is
an index gather, which copies each point exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.curves import take_rows

_INT32_MAX = 2**31 - 1


class CollisionScan(NamedTuple):
    found: torch.Tensor       # (B,) bool
    xy: torch.Tensor          # (B, 2) collision point on the detailed path
    frame_idx: torch.Tensor   # (B,) int32 index into the detailed path


def _circle_points(x, y, th, circle_centers):
    """Circle centers of poses (..., F) and offsets (n_c, 2) -> px, py each
    (..., n_c, F)."""
    c, s = torch.cos(th), torch.sin(th)
    ox, oy = circle_centers[:, 0:1], circle_centers[:, 1:2]
    px = x[..., None, :] + c[..., None, :] * ox - s[..., None, :] * oy
    py = y[..., None, :] + s[..., None, :] * ox + c[..., None, :] * oy
    return px, py


def check_collision_moving_cars(
    ego_traj,          # (B, N_F, 3) padded resampled ego future trajectory
    n_ego,             # (B,) int32
    detail_traj,       # (B, N_T, 3) padded detailed path
    n_detail,          # (B,) int32
    obs_trajs,         # (B, n_obs, n_pred, 3) predicted obstacle trajectories
    obs_active,        # (B, n_obs) bool
    circle_centers,    # (n_c, 2)
    radius: float,
    frame_window: int,
    n_frames: int,     # frame buffer (>= any max(n_ego, n_pred))
) -> CollisionScan:
    B, n_obs, n_pred, _ = obs_trajs.shape
    dev = ego_traj.device
    min_d2 = (2.0 * radius) ** 2
    n_c = circle_centers.shape[0]

    # the lexicographic first-hit key is encoded in int32 (as in the JAX
    # package); every factor is a Python int, so guard its range here
    S = 2 * frame_window + 1
    max_key = n_frames * n_c * n_obs * S * n_c
    if max_key >= _INT32_MAX:
        raise ValueError(
            "collision first-hit key would overflow int32: "
            f"n_frames*n_c^2*n_obs*(2*frame_window+1) = {max_key} >= 2^31-1")

    frames = torch.arange(n_frames, device=dev)
    n_iter = torch.clamp(n_ego, min=n_pred)
    frame_valid = frames[None, :] < n_iter[:, None]                  # (B, N_F)

    ego_idx = torch.minimum(frames[None, :], torch.clamp(n_ego - 1, min=0)[:, None])
    ego_pose = torch.gather(ego_traj, 1, ego_idx[..., None].expand(-1, -1, 3))
    ego_px, ego_py = _circle_points(ego_pose[..., 0], ego_pose[..., 1], ego_pose[..., 2],
                                    circle_centers)                  # (B, n_c, N_F)

    # shift s delays the prediction by s frames (s < 0 advances it)
    shifts = torch.arange(-frame_window, frame_window + 1, device=dev)
    src = torch.clamp(frames[None, :] - shifts[:, None], 0, n_pred - 1)  # (S, N_F)
    opx, opy = _circle_points(obs_trajs[..., 0], obs_trajs[..., 1], obs_trajs[..., 2],
                              circle_centers)                        # (B, n_obs, n_c, n_pred)
    obs_px = opx[..., src].permute(0, 1, 3, 2, 4)                    # (B, n_obs, S, n_c, N_F)
    obs_py = opy[..., src].permute(0, 1, 3, 2, 4)

    # frame-aligned pairwise hit test, (B, n_obs, S, n_c_e, n_c_o, N_F)
    dx = ego_px[:, None, None, :, None, :] - obs_px[:, :, :, None, :, :]
    dy = ego_py[:, None, None, :, None, :] - obs_py[:, :, :, None, :, :]
    hit = dx * dx + dy * dy <= min_d2
    hit = hit & frame_valid[:, None, None, None, None, :]
    hit = hit & obs_active[:, :, None, None, None, None]

    f_ix = frames[None, None, None, None, :]
    ce_ix = torch.arange(n_c, device=dev)[None, None, :, None, None]
    o_ix = torch.arange(n_obs, device=dev)[:, None, None, None, None]
    s_ix = torch.arange(S, device=dev)[None, :, None, None, None]
    co_ix = torch.arange(n_c, device=dev)[None, None, None, :, None]
    key = ((((f_ix * n_c + ce_ix) * n_obs + o_ix) * S + s_ix) * n_c + co_ix).to(torch.int32)
    big = torch.tensor(_INT32_MAX, dtype=torch.int32, device=dev)
    first = torch.where(hit, key, big).reshape(B, -1).amin(dim=1)
    found = first < big
    first = torch.where(found, first, torch.zeros_like(first)).to(torch.int64)

    # decode the colliding (obstacle, shift, frame, obstacle-circle) and
    # recompute that one circle point
    co = first % n_c
    s_i = (first // n_c) % S
    o_i = (first // (n_c * S)) % n_obs
    f_i = first // (n_c * S * n_obs * n_c)
    src_f = torch.clamp(f_i - shifts[s_i], 0, n_pred - 1)
    bidx = torch.arange(B, device=dev)
    pose = obs_trajs[bidx, o_i, src_f]                               # (B, 3)
    ox, oy = circle_centers[co, 0], circle_centers[co, 1]
    c2, s2 = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
    obs_x = pose[:, 0] + c2 * ox - s2 * oy
    obs_y = pose[:, 1] + s2 * ox + c2 * oy

    # re-localize on the detailed path: circle-major scan, argmax % N_T
    N_T = detail_traj.shape[1]
    det_px, det_py = _circle_points(detail_traj[..., 0], detail_traj[..., 1],
                                    detail_traj[..., 2], circle_centers)  # (B, n_c, N_T)
    ddx = det_px - obs_x[:, None, None]
    ddy = det_py - obs_y[:, None, None]
    hit2 = ddx * ddx + ddy * ddy <= min_d2
    hit2 = hit2 & (torch.arange(N_T, device=dev)[None, :] < n_detail[:, None])[:, None, :]
    first2 = torch.argmax(hit2.reshape(B, -1).to(torch.uint8), dim=1)
    frame_idx = (first2 % N_T).to(torch.int32)
    xy = take_rows(detail_traj, frame_idx)[:, :2]
    return CollisionScan(found=found, xy=xy, frame_idx=frame_idx)


def cutoff_index_by_position(points, n_valid, xy, radius: float = 0.001):
    """First index of ``points`` (B, N, >=2) within ``radius`` of ``xy``
    (B, 2) (reference ``collision_avoidance.py:107-119``). Returns
    (found (B,) bool, idx (B,) int32)."""
    N = points.shape[1]
    d = points[..., :2] - xy[:, None, :]
    near = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) <= radius
    near = near & (torch.arange(N, device=points.device)[None, :] < n_valid[:, None])
    idx = torch.argmax(near.to(torch.uint8), dim=1)
    found = torch.gather(near, 1, idx[:, None])[:, 0]
    return found, idx.to(torch.int32)
