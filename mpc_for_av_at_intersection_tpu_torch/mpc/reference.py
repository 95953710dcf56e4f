"""Velocity-lookahead reference extraction from padded courses, batched.

Port of ``mpc_for_av_at_intersection_tpu/mpc/reference.py`` (reference
``main/lib/mpc.py:86-109``): advance the course-localization index in the
travel direction, then index the course by predicted travel distance
(cumsum of |planned speed| * dt quantized to the course tick dl, rounding
half to even like ``np.rint``), clamped to the course end; mark horizon
slots that hit the end (``reaches_end``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.curves import nearest_index_in_direction


class ReferenceOut(NamedTuple):
    xref: torch.Tensor         # (B, 4, T+1): x, y, v, yaw rows
    target_idx: torch.Tensor   # (B,) int32 updated localization index
    reaches_end: torch.Tensor  # (B, T+1) bool


def compute_reference(
    states,          # (B, 4) x, y, v, yaw
    courses,         # (B, N, 3) padded x, y, yaw
    course_speeds,   # (B, N) speed channel (zeros if unused)
    valid_lens,      # (B,) int32
    dls,             # (B,) course tick
    start_idx,       # (B,) int32
    ov,              # (B, T+1) planned speeds from the previous solve
    have_ov,         # (B,) bool, False on the first tick
    T: int,
    dt: float,
    fallback_speed: float = 10.0 / 3.6,
    use_speed_channel: bool = False,
) -> ReferenceOut:
    target_idx = nearest_index_in_direction(
        states[:, :2], courses[:, :, :2], start_idx, valid_lens, forward=True)

    default_ov = torch.clamp(states[:, 2:3], min=fallback_speed).expand(-1, T + 1)
    ov_eff = torch.where(have_ov[:, None], ov, default_ov)
    travel = torch.cumsum(torch.abs(ov_eff) * dt, dim=1)
    idx = torch.round(travel / dls[:, None]).to(torch.int32)
    last = valid_lens[:, None].to(torch.int32) - 1
    idx = torch.minimum(idx + target_idx[:, None], last)

    gi = idx.to(torch.int64)

    def take(rows):
        return torch.gather(rows, 1, gi)

    speed = (take(course_speeds) if use_speed_channel
             else torch.zeros_like(ov_eff, dtype=courses.dtype))
    xref = torch.stack(
        [take(courses[:, :, 0]), take(courses[:, :, 1]), speed,
         take(courses[:, :, 2])], dim=1)
    return ReferenceOut(xref, target_idx, idx == last)
