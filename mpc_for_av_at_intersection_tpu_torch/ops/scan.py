"""The conflict scan's first hit on the card: the CUDA kernel ``csrc/scan.cu``.

``first_hit_scan`` launches it for CUDA tensors (and for those only: it
has no plain path of its own). ``agents/collision.py::
check_collision_moving_cars`` calls it on the card and runs its plain
version, ``check_collision_moving_cars_reference``, on the CPU. It replaces
no TPU kernel: the JAX package computes the scan in plain ``jnp``
(``mpc_for_av_at_intersection_tpu/agents/collision.py``), and the kernel
exists because the plain torch scan, which writes its pairwise hit test
out in full, took most of a fleet tick on the card.

One CTA a row walks the row's frames in order and stops after the first
frame that holds a hit; it tests only the active obstacles, and never a
frame past ``n_iter = max(n_ego, n_pred)``. Its outputs ``found``, ``xy``
and ``frame_idx`` are the plain version's bit for bit: both take the
cosines and sines of the headings from torch, and the kernel (built
without multiply-add contraction) rounds each step as the plain version's
separate tensor operations do. ``frames`` counts the frames each row
walked (``frames_walked``, the plain count).

The launch shape follows the shapes (``launch_shape``): a thread a unit
(active obstacle, shift, obstacle circle) of one frame, up to
``THREADS_MAX`` threads; as many obstacles' circle points in shared memory
as fit beside a chunk of ego points, the rest in further tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build

INT32_MAX = 2**31 - 1
THREADS_MAX = 256     # threads a CTA (a row)
EGO_POINTS = 1024     # (frame, circle) ego points in shared memory at a time
CTL_INTS = 40         # the kernel's control words in shared memory (SCAN_CTL_INTS)


class ScanResult(NamedTuple):
    found: torch.Tensor       # (B,) bool
    xy: torch.Tensor          # (B, 2) collision point on the detailed path
    frame_idx: torch.Tensor   # (B,) int32 index into the detailed path
    frames: torch.Tensor      # (B,) int32 frames the row walked


def check_key_range(n_frames: int, n_c: int, n_obs: int, frame_window: int):
    """Raise unless the lexicographic first-hit key, encoded in int32 as
    in the JAX package, stays within its range."""
    max_key = n_frames * n_c * n_obs * (2 * frame_window + 1) * n_c
    if max_key >= INT32_MAX:
        raise ValueError(
            "collision first-hit key would overflow int32: "
            f"n_frames*n_c^2*n_obs*(2*frame_window+1) = {max_key} >= 2^31-1")


def smem_bytes(n_c: int, n_pred: int, tile_obs: int, ego_points: int) -> int:
    """Shared memory of one CTA: the tile's obstacle points, the chunk's ego
    points, the tile's slot list and the control words (as the kernel's
    ``smem_bytes`` counts them)."""
    return 8 * tile_obs * n_c * n_pred + 8 * ego_points + 4 * max(tile_obs, 1) + 4 * CTL_INTS


def launch_shape(n_obs: int, n_c: int, frame_window: int, n_pred: int, n_frames: int):
    """(threads, tile_obs, ego_points): a thread for each of a frame's units
    (obstacle, shift, obstacle circle), each testing its point against the
    frame's n_c ego circles, up to THREADS_MAX; the most obstacles whose
    circle points fit in shared memory beside a chunk of ego points (0:
    not one, each point placed from device memory where it is tested)."""
    units = n_obs * (2 * frame_window + 1) * n_c
    threads = min(THREADS_MAX, -(-units // 32) * 32)
    ego_points = min(n_frames * n_c, EGO_POINTS)
    room = _build.SMEM_LIMIT - smem_bytes(n_c, n_pred, 0, ego_points) + 4
    tile_obs = min(n_obs, room // (8 * n_c * n_pred + 4))
    return threads, tile_obs, ego_points


def first_hit_scan(ego_traj, n_ego, detail_traj, n_detail, obs_trajs, obs_active,
                   circle_centers, radius: float, frame_window: int,
                   n_frames: int) -> ScanResult:
    """The conflict scan of ``check_collision_moving_cars`` in one kernel
    launch, with the frames each row walked: ego_traj (B, N_F, 3), detail_traj
    (B, N_T, 3), obs_trajs (B, n_obs, n_pred, 3) and circle_centers (n_c, 2)
    float32, n_ego and n_detail (B,) int32, obs_active (B, n_obs) bool, all
    contiguous on one CUDA device."""
    B, N_F, _ = ego_traj.shape
    N_T = detail_traj.shape[1]
    _, n_obs, n_pred, _ = obs_trajs.shape
    n_c = circle_centers.shape[0]
    for name, t, shape, dtype in (
            ("ego_traj", ego_traj, (B, N_F, 3), torch.float32),
            ("n_ego", n_ego, (B,), torch.int32),
            ("detail_traj", detail_traj, (B, N_T, 3), torch.float32),
            ("n_detail", n_detail, (B,), torch.int32),
            ("obs_trajs", obs_trajs, (B, n_obs, n_pred, 3), torch.float32),
            ("obs_active", obs_active, (B, n_obs), torch.bool),
            ("circle_centers", circle_centers, (n_c, 2), torch.float32)):
        _build.check_cuda(name, t, shape, dtype)
    dev = ego_traj.device
    if any(t.device != dev for t in (n_ego, detail_traj, n_detail, obs_trajs, obs_active,
                                     circle_centers)):
        raise ValueError("first_hit_scan: tensors on more than one device")
    if min(B, N_F, N_T, n_obs, n_pred, n_c, n_frames) < 1 or frame_window < 0:
        raise ValueError(f"first_hit_scan: nothing to scan (B={B}, N_F={N_F}, N_T={N_T}, "
                         f"n_obs={n_obs}, n_pred={n_pred}, n_c={n_c}, n_frames={n_frames}, "
                         f"frame_window={frame_window})")
    check_key_range(n_frames, n_c, n_obs, frame_window)
    threads, tile_obs, ego_points = launch_shape(n_obs, n_c, frame_window, n_pred, n_frames)

    # the headings' cosines and sines from torch, as the plain version takes them
    trig = [f(t[..., 2]).contiguous() for t in (ego_traj, detail_traj, obs_trajs)
            for f in (torch.cos, torch.sin)]
    # the comparison rounds (2 radius)^2 to float32, as torch's does
    min_d2 = float(np.float32((2.0 * radius) ** 2))
    found = torch.empty(B, dtype=torch.bool, device=dev)
    xy = torch.empty((B, 2), dtype=torch.float32, device=dev)
    frame_idx = torch.empty(B, dtype=torch.int32, device=dev)
    frames = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.scan_first_hit(
            ego_traj.data_ptr(), trig[0].data_ptr(), trig[1].data_ptr(), n_ego.data_ptr(),
            detail_traj.data_ptr(), trig[2].data_ptr(), trig[3].data_ptr(), n_detail.data_ptr(),
            obs_trajs.data_ptr(), trig[4].data_ptr(), trig[5].data_ptr(), obs_active.data_ptr(),
            circle_centers.data_ptr(), min_d2, B, N_F, N_T, n_obs, n_pred, n_c, frame_window,
            n_frames, threads, tile_obs, ego_points, found.data_ptr(), xy.data_ptr(),
            frame_idx.data_ptr(), frames.data_ptr(), _build.stream_handle(dev))
    _build.raise_on_error("conflict scan first_hit_scan", err)
    first_hit_scan.launches += 1
    return ScanResult(found=found, xy=xy, frame_idx=frame_idx, frames=frames)


first_hit_scan.launches = 0
