"""A device trace of whole ticks: ``torch.profiler`` over the ticks, its
Chrome trace written into the run's temporary directory, and the
arithmetic the per-layer readers share (as ``chip_smoke.py``'s
``tick_profile`` and ``utils/timing.py::device_profile`` take it, read
from the trace's timeline instead of ``key_averages``)."""

from __future__ import annotations

import bisect
import json
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "port_bench.ticks"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Device activity of ``ticks`` ticks inside the traced window."""

    def __init__(self, events, ticks: int):
        win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.ticks = ticks

        def inside(e):
            return e.get("ph") == "X" and self.t0 <= float(e["ts"]) <= self.t1

        self.device = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
                       for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"]))
                     for e in events if e.get("cat") == "cpu_op" and inside(e)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, self.t0
        for _, ts, dur, _ in sorted(self.device, key=lambda e: e[1]):
            lo, hi = max(ts, end), min(ts + dur, self.t1)
            if hi > lo:
                busy += hi - lo
            end = max(end, ts + dur)
        return busy * 1e-6

    def kernels(self):
        return [e for e in self.device if e[3] == "kernel"]

    def ms_per_tick(self, names=None, exclude=None) -> float:
        """Device ms a tick of the activities whose name contains one of
        ``names`` (all if None) and none of ``exclude``."""
        tot = 0.0
        for name, _, dur, _ in self.device:
            if names is not None and not any(n in name for n in names):
                continue
            if exclude is not None and any(n in name for n in exclude):
                continue
            tot += dur
        return tot * 1e-3 / self.ticks

    def device_ops(self, top=10):
        by = defaultdict(float)
        for name, _, dur, _ in self.device:
            by[name[:120]] += dur * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """Idle device time by what the host was doing: each gap between
        device activities is charged to the innermost host operation open
        at its middle."""
        spans = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        gaps, end = [], self.t0
        for lo, hi in spans:
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        by = defaultdict(float)
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            label = "host outside any operator"
            # the latest-starting open operator is the innermost one
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                name, ts, dur = host[i]
                if ts + dur >= mid:
                    label = name
                    break
                if mid - ts > 1e5:     # 0.1 s back: no operator is open
                    break
            by[label] += (hi - lo) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def profile_ticks(fleet, state, ticks: int, tag: str) -> Trace:
    """Trace ``ticks`` ticks from ``state`` and read the trace back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            st = state
            for _ in range(ticks):
                st, _ = fleet.tick(st)
            torch.cuda.synchronize()
    out = Path(tempfile.gettempdir()) / "port_bench"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{tag}.trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tr = Trace(events, ticks)
    tr.path, tr.nbytes = path, path.stat().st_size
    return tr
