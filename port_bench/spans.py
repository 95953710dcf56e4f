"""The program's own spans and counters in a traced run.

The port opens ``record_function`` spans at its tick's stages and at K1
and K2 while a ``torch.profiler`` session records
(``mpc_for_av_at_intersection_tpu_torch/utils/timing.py``), so they sit in
the trace file beside the kernels, on the same clock. Here each device
activity of the traced window (kernel, copy or fill) is mapped through its
``correlation`` argument to the runtime or driver call that launched it,
and charged to the innermost program span open on that call's host thread
at its start: a span's self share, its children's left out. An activity
whose launch is in no program span is charged to none.

The counters are the program's ``counters()``, summed over the newest
traced session. A program without spans or counters (before they were
added) gives None for each.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from functools import lru_cache

from .trace import DEVICE_CATS, WINDOW

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@lru_cache(maxsize=2)
def _charged(path: str, mtime: float) -> dict:
    """{span name: [device us, kernels]} of the trace at ``path``, each
    activity charged to the innermost program span open at its launch;
    every span the program opened in the window has its entry."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = next(e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation")
    t0 = float(win["ts"])
    t1 = t0 + float(win["dur"])

    def inside(e):
        return e.get("ph") == "X" and t0 <= float(e["ts"]) <= t1

    by_thread = defaultdict(list)
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] != WINDOW and inside(e):
            ts = float(e["ts"])
            by_thread[(e.get("pid"), e.get("tid"))].append((ts, ts + float(e["dur"]), e["name"]))
            out.setdefault(e["name"], [0.0, 0])
    for spans in by_thread.values():
        spans.sort()
    starts = {k: [s[0] for s in v] for k, v in by_thread.items()}
    launches = {e["args"]["correlation"]: (float(e["ts"]), (e.get("pid"), e.get("tid")))
                for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}

    def innermost(ts, thread):
        spans = by_thread.get(thread, [])
        # spans nest, so the latest-starting span still open is the innermost
        for i in range(bisect.bisect_right(starts.get(thread, []), ts) - 1, -1, -1):
            if spans[i][1] >= ts:
                return spans[i][2]
        return None

    for e in events:
        if e.get("cat") not in DEVICE_CATS or not inside(e):
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = innermost(*launch) if launch else None
        if name is not None:
            out[name][0] += float(e["dur"])
            out[name][1] += int(e["cat"] == "kernel")
    return out


def charged(ctx, name: str):
    """(device us, kernels) charged to the span ``name`` itself over the
    traced ticks, or None where the program opened no such span."""
    path = str(ctx["trace"].path)
    got = _charged(path, os.path.getmtime(path)).get(name)
    return None if got is None else tuple(got)


def ms_per_tick(ctx, name: str):
    """Device ms a tick of the kernels, copies and fills launched in the
    span ``name`` and in none of its children."""
    got = charged(ctx, name)
    return None if got is None else got[0] * 1e-3 / ctx["trace"].ticks


def launches_per_tick(ctx, name: str):
    """Kernels a tick launched in the span ``name`` and in none of its
    children."""
    got = charged(ctx, name)
    return None if got is None else got[1] / ctx["trace"].ticks


def counter(name: str):
    """The program's counter ``name`` summed over the newest traced
    session, or None where the program keeps no such counter."""
    try:
        from mpc_for_av_at_intersection_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "counters", None)
    return None if read is None else read().get(name)


def solved_rows(ctx) -> int:
    """Rows the traced ticks' solves took: every row of the fleet, once a
    re-linearization."""
    return ctx["fleet"].rows * ctx["trace"].ticks * max(ctx["config"]["mpc"]["max_iter"], 1)
