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

On the card ``check_collision_moving_cars`` launches one CUDA kernel
(``ops/scan.py::first_hit_scan``), which walks each row's frames in order
and stops after the first frame that holds a hit, bit for bit the plain
version; on the CPU it runs the plain version,
``check_collision_moving_cars_reference``.

Eager PyTorch materializes the pairwise hit test, n_obs (2 frame_window +
1) n_c^2 n_frames elements a row (~210,000 for the 8-ego junction), so in
the plain version steps 1-3 run over slices of rows that keep each such
tensor within ``SCAN_ELEMENTS``: every op there is row-local, so a sliced
scan equals a whole one bit for bit, and the peak memory stays bounded
whatever the batch (the JAX package bounds it with its engines'
``pre_chunk`` options instead, which also rerun the predictions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.curves import take_rows
from ..ops.scan import INT32_MAX, check_key_range, first_hit_scan
from ..utils.timing import count

SCAN_ELEMENTS = 1 << 28   # most elements of one tensor of the pairwise hit test


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


def scan_row_elements(n_obs: int, n_c: int, frame_window: int, n_frames: int) -> int:
    """Elements of one row of the pairwise hit test."""
    return n_obs * (2 * frame_window + 1) * n_c * n_c * n_frames


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
    """The conflict scan: the kernel on the card (the frames each row
    walked counted as ``scan.frames`` while a profiler records), the plain
    version on the CPU."""
    if ego_traj.device.type == "cpu":
        return check_collision_moving_cars_reference(
            ego_traj, n_ego, detail_traj, n_detail, obs_trajs, obs_active, circle_centers,
            radius, frame_window, n_frames)
    out = first_hit_scan(ego_traj.contiguous(), n_ego.contiguous(), detail_traj.contiguous(),
                         n_detail.contiguous(), obs_trajs.contiguous(), obs_active.contiguous(),
                         circle_centers.contiguous(), radius, frame_window, n_frames)
    count("scan.frames", out.frames)
    return CollisionScan(found=out.found, xy=out.xy, frame_idx=out.frame_idx)


def _first_hits(ego_traj, n_ego, obs_trajs, obs_active, circle_centers, min_d2,
                frame_window: int, n_frames: int):
    """(found (B,) bool, first (B,) int64): each row's least first-hit key
    (((f n_c + ce) n_obs + o) S + s) n_c + co, 0 where none, computed over
    slices of rows."""
    B, n_obs, n_pred, _ = obs_trajs.shape
    dev = ego_traj.device
    n_c = circle_centers.shape[0]
    S = 2 * frame_window + 1
    # the lexicographic first-hit key is encoded in int32 (as in the JAX
    # package); every factor is a Python int, so guard its range here
    check_key_range(n_frames, n_c, n_obs, frame_window)

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

    f_ix = frames[None, None, None, None, :]
    ce_ix = torch.arange(n_c, device=dev)[None, None, :, None, None]
    o_ix = torch.arange(n_obs, device=dev)[:, None, None, None, None]
    s_ix = torch.arange(S, device=dev)[None, :, None, None, None]
    co_ix = torch.arange(n_c, device=dev)[None, None, None, :, None]
    key = ((((f_ix * n_c + ce_ix) * n_obs + o_ix) * S + s_ix) * n_c + co_ix).to(torch.int32)
    big = torch.tensor(INT32_MAX, dtype=torch.int32, device=dev)

    def first_hit(r):
        """The first hit's key of the rows ``r`` (big where none)."""
        obs_px = opx[r][..., src].permute(0, 1, 3, 2, 4)             # (R, n_obs, S, n_c, N_F)
        obs_py = opy[r][..., src].permute(0, 1, 3, 2, 4)
        # frame-aligned pairwise hit test, (R, n_obs, S, n_c_e, n_c_o, N_F)
        dx = ego_px[r][:, None, None, :, None, :] - obs_px[:, :, :, None, :, :]
        dy = ego_py[r][:, None, None, :, None, :] - obs_py[:, :, :, None, :, :]
        hit = dx * dx + dy * dy <= min_d2
        hit = hit & frame_valid[r][:, None, None, None, None, :]
        hit = hit & obs_active[r][:, :, None, None, None, None]
        return torch.where(hit, key, big).reshape(hit.shape[0], -1).amin(dim=1)

    rows = max(1, SCAN_ELEMENTS // scan_row_elements(n_obs, n_c, frame_window, n_frames))
    first = torch.cat([first_hit(slice(i, i + rows)) for i in range(0, B, rows)])
    found = first < big
    return found, torch.where(found, first, torch.zeros_like(first)).to(torch.int64)


def check_collision_moving_cars_reference(
    ego_traj, n_ego, detail_traj, n_detail, obs_trajs, obs_active, circle_centers,
    radius: float, frame_window: int, n_frames: int,
) -> CollisionScan:
    """Plain version of ``check_collision_moving_cars``, any device: the
    pairwise hit test written out over slices of rows."""
    B, n_obs, n_pred, _ = obs_trajs.shape
    dev = ego_traj.device
    min_d2 = (2.0 * radius) ** 2
    n_c = circle_centers.shape[0]
    S = 2 * frame_window + 1
    found, first = _first_hits(ego_traj, n_ego, obs_trajs, obs_active, circle_centers, min_d2,
                               frame_window, n_frames)

    # decode the colliding (obstacle, shift, frame, obstacle-circle) and
    # recompute that one circle point
    shifts = torch.arange(-frame_window, frame_window + 1, device=dev)
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


def frames_walked(ego_traj, n_ego, obs_trajs, obs_active, circle_centers, radius: float,
                  frame_window: int, n_frames: int):
    """(B,) int32, the plain count of the kernel's ``frames``: the frames a
    row walks up to and with its first hitting frame, all of
    min(max(n_ego, n_pred), n_frames) where none hits, 0 where no obstacle
    is active."""
    n_pred = obs_trajs.shape[2]
    key_per_frame = obs_trajs.shape[1] * (2 * frame_window + 1) * circle_centers.shape[0] ** 2
    found, first = _first_hits(ego_traj, n_ego, obs_trajs, obs_active, circle_centers,
                               (2.0 * radius) ** 2, frame_window, n_frames)
    walked = torch.where(found, first // key_per_frame + 1,
                         torch.clamp(n_ego.to(torch.int64), min=n_pred).clamp(max=n_frames))
    return torch.where(obs_active.any(dim=1), walked, torch.zeros_like(walked)).to(torch.int32)


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
