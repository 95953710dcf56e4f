"""The conflict scan's CPU side (the kernel itself runs only on the card,
``tests/test_torch_kernels_cuda.py``):

- on CPU tensors ``check_collision_moving_cars`` runs its plain version
  and launches nothing; on any other device it goes to the kernel path,
  which refuses a tensor that is not on a CUDA device before anything is
  built;
- ``frames_walked``, the plain count the card test holds the kernel's
  ``frames`` to, is a loop's count: the frames up to and with the first
  frame that holds a hit of an active obstacle, all of
  min(max(n_ego, n_pred), n_frames) where none does, none where no
  obstacle is active;
- the launch shape follows the shapes: a thread a unit of one frame up to
  256, and the most obstacles' circle points that fit a CTA's shared memory
  (none where one obstacle's do not);
- ctypes passes each argument as ``ops/_build.py`` declares it, and the
  kernel source's constants are the wrapper's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu_torch.agents import collision
from mpc_for_av_at_intersection_tpu_torch.ops import _build, scan

SOURCE = Path(collision.__file__).resolve().parent.parent / "csrc" / "scan.cu"
CENTERS = [[-0.6, 0.0], [1.9, 0.0]]


def _rows(B, n_obs, n_pred, n_frames, fw, seed, device="cpu"):
    """Random rows: ego courses and detailed paths, obstacle predictions
    drifting through the ego's area, 70% of the slots active, some rows
    with none, n_ego in [0, n_frames + 4)."""
    rng = np.random.default_rng(seed)

    def walk(shape, step):
        yaw = rng.uniform(-np.pi, np.pi, shape[:-1] + (1,)) + rng.normal(0, 0.1, shape).cumsum(-1)
        xy = (np.stack([np.cos(yaw), np.sin(yaw)], -1) * step).cumsum(-2)
        return np.concatenate([xy, yaw[..., None]], -1)

    obs = walk((B, n_obs, n_pred), 0.6)
    obs[..., :2] += rng.uniform(-15, 15, (B, n_obs, 1, 2))
    active = rng.uniform(size=(B, n_obs)) < 0.7
    active[:3] = False
    t = lambda a, dtype=torch.float32: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return [t(walk((B, n_frames), 0.4)), t(rng.integers(0, n_frames + 4, B), torch.int32),
            t(walk((B, 24), 0.4)), t(rng.integers(0, 25, B), torch.int32), t(obs),
            t(active, torch.bool), t(CENTERS), 1.1, fw, n_frames]


def _first_frames(args):
    """(found, first frame) of each row by loops over frames and pairs, in
    float32 as the plain version rounds."""
    ego, n_ego, _, _, obs, active, centers, radius, fw, n_frames = args
    B, n_obs, n_pred, _ = obs.shape
    f32 = np.float32
    min_d2 = f32((2.0 * radius) ** 2)

    def points(traj):
        c, s = torch.cos(traj[..., 2]).numpy(), torch.sin(traj[..., 2]).numpy()
        x, y = traj[..., 0].numpy(), traj[..., 1].numpy()
        return [((x + c * ox) - s * oy, (y + s * ox) + c * oy) for ox, oy in centers.numpy()]

    ego_pts, obs_pts = points(ego), points(obs)
    found, first = [], []
    for b in range(B):
        ne = int(n_ego[b])
        hit = None
        for f in range(min(max(ne, n_pred), n_frames)):
            e = min(f, max(ne - 1, 0))
            for o in np.flatnonzero(active[b].numpy()):
                j = np.clip(f - np.arange(-fw, fw + 1), 0, n_pred - 1)
                for ex, ey in ego_pts:
                    for ox, oy in obs_pts:
                        dx, dy = f32(ex[b, e]) - ox[b, o, j], f32(ey[b, e]) - oy[b, o, j]
                        if bool(((dx * dx + dy * dy) <= min_d2).any()):
                            hit = f
                            break
                    if hit is not None:
                        break
                if hit is not None:
                    break
            if hit is not None:
                break
        found.append(hit is not None)
        first.append(hit)
    return found, first


@pytest.mark.parametrize("n_pred,fw", [(5, 2), (1, 2), (7, 20)])
def test_frames_walked_counts_up_to_the_first_hitting_frame(n_pred, fw):
    args = _rows(40, 3, n_pred, 12, fw, seed=n_pred + fw)
    ego, n_ego, _, _, obs, active, centers, radius, _, n_frames = args
    found, first = _first_frames(args)
    want = [0 if not bool(active[b].any()) else first[b] + 1 if found[b]
            else min(max(int(n_ego[b]), n_pred), n_frames) for b in range(len(found))]
    walked = collision.frames_walked(ego, n_ego, obs, active, centers, radius, fw, n_frames)
    assert walked.dtype == torch.int32 and walked.tolist() == want
    assert collision.check_collision_moving_cars(*args).found.tolist() == found
    assert any(found) and not all(found) and 0 in want


def test_cpu_scan_runs_the_plain_version_and_launches_nothing():
    args = _rows(16, 4, 35, 40, 20, seed=1)
    before = scan.first_hit_scan.launches
    got = collision.check_collision_moving_cars(*args)
    want = collision.check_collision_moving_cars_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert scan.first_hit_scan.launches == before


def test_a_scan_on_another_device_goes_to_the_kernel_and_is_refused_there():
    args = _rows(4, 3, 5, 12, 2, seed=2)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    before = scan.first_hit_scan.launches
    with pytest.raises(ValueError, match="ego_traj: expected a CUDA tensor"):
        collision.check_collision_moving_cars(*meta)
    # the wrapper has no plain path: CPU tensors are refused too
    with pytest.raises(ValueError, match="ego_traj: expected a CUDA tensor"):
        scan.first_hit_scan(*args)
    assert scan.first_hit_scan.launches == before


@pytest.mark.parametrize("shape,want", [
    ((10, 2, 20, 35, 128), (256, 10, 256)),       # the multi-ego cell: 8 egos, 2 agent slots
    ((4, 2, 20, 35, 128), (256, 4, 256)),         # the fleet cell
    ((1, 2, 0, 35, 128), (32, 1, 256)),           # one unit a frame
    ((64, 2, 20, 300, 300), (256, 47, 600)),      # tiles of 47 obstacles
    ((2, 2, 20, 15000, 15000), (192, 0, 1024)),   # one obstacle's points exceed a CTA's
])
def test_launch_shape_follows_the_shapes(shape, want):
    n_obs, n_c, _, n_pred, _ = shape
    threads, tile, ego = scan.launch_shape(*shape)
    assert (threads, tile, ego) == want
    assert scan.smem_bytes(n_c, n_pred, tile, ego) <= _build.SMEM_LIMIT
    if tile < n_obs:
        assert scan.smem_bytes(n_c, n_pred, tile + 1, ego) > _build.SMEM_LIMIT


def test_scan_signature_matches_the_kernel_entry_point():
    src = SOURCE.read_text()
    params = re.search(r'extern "C" int scan_first_hit\((.*?)\)\s*\{', src, re.S).group(1)
    kinds = [_build._I if re.match(r"\s*int \w+$", p) else
             _build._F if re.match(r"\s*float \w+$", p) else _build._P for p in params.split(",")]
    assert _build._SIGNATURES["scan_first_hit"] == (kinds, _build._I)
    assert kinds.count(_build._F) == 1
    assert _build.SOURCE_FLAGS["scan.cu"] == ("--fmad=false",)
    assert int(re.search(r"SCAN_CTL_INTS = (\d+);", src).group(1)) == scan.CTL_INTS
    assert int(re.search(r"SCAN_SMEM_LIMIT = (\d+);", src).group(1)) == _build.SMEM_LIMIT
    body = re.search(r"int smem_bytes\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "8LL * tile_obs * n_c * n_pred + 8LL * ego_points" in body
    assert "4LL * (tile_obs > 0 ? tile_obs : 1) + 4LL * SCAN_CTL_INTS" in body
