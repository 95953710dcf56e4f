"""Wall-clock records, a device profile capture, and the program's spans
and counters.

Port of ``mpc_for_av_at_intersection_tpu/utils/timing.py``: the reference's
``@measure_time`` decorator, a context manager, aggregate statistics, and
``device_profile``, which records a ``torch.profiler`` trace (CPU and, where
a card is present, CUDA activity) and writes it as a Chrome trace.

The engines mark their stages with ``span`` and K2's work with ``count``.
Both act only while a ``torch.profiler`` session records, which is their
one switch: a span is then a ``record_function`` in the same Chrome trace
as the kernels it launches, on the profiler's clock, and a counter keeps
its per-row tensor by reference (no reduction, copy or synchronization
where it counts). With no session each costs one test of the profiler's
state. ``counters()`` sums each counter over the newest traced session.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

_RECORDS: Dict[str, List[float]] = defaultdict(list)
_NO_SPAN = contextlib.nullcontext()
# each counter's tensors of the newest traced session, and the elements they
# hold; past COUNT_KEEP elements they are summed into one on their device (a
# concatenation and a sum, launched in the span that counts), which bounds
# the memory they hold
COUNT_KEEP = 1 << 24
_COUNTS: Dict[str, List[torch.Tensor]] = {}
_KEPT: Dict[str, int] = {}
_session_over = True    # the profiler was found off since the last count


def measure_time(fn=None, *, name=None):
    """Decorator recording wall time per call (also printed, like the
    reference helper)."""

    def wrap(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def inner(*a, **kw):
            t0 = time.perf_counter()
            out = f(*a, **kw)
            dt = time.perf_counter() - t0
            _RECORDS[label].append(dt)
            print(f"[timing] {label}: {dt * 1e3:.2f} ms")
            return out

        return inner

    return wrap(fn) if fn is not None else wrap


@contextlib.contextmanager
def timed(label: str, verbose: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    _RECORDS[label].append(dt)
    if verbose:
        print(f"[timing] {label}: {dt * 1e3:.2f} ms")


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {
        k: {
            "n": len(v),
            "mean_ms": float(np.mean(v) * 1e3),
            "p50_ms": float(np.percentile(v, 50) * 1e3),
            "max_ms": float(np.max(v) * 1e3),
        }
        for k, v in _RECORDS.items()
    }


def reset_timing() -> None:
    _RECORDS.clear()


@contextlib.contextmanager
def device_profile(out_dir: str):
    """Record a ``torch.profiler`` trace of the block and write it to
    ``out_dir/trace.json`` (open in Perfetto or chrome://tracing). Yields
    the profiler, whose ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _recording() -> bool:
    """Whether a ``torch.profiler`` session records. Finding none ends the
    session the counters hold, and the next count starts a new one: so two
    sessions are told apart by an untraced tick or a read of ``counters()``
    between them."""
    global _session_over
    on = torch.autograd._profiler_enabled()
    if not on:
        _session_over = True
    return on


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler session
    records, else a shared no-op context."""
    return torch.profiler.record_function(name) if _recording() else _NO_SPAN


def count(name: str, values) -> None:
    """Keep ``values`` (a tensor of per-row counts, or None: nothing) for
    the counter ``name`` while a profiler session records. A session that
    counts more than COUNT_KEEP elements a counter (1,677 solves of
    10,000 rows) launches their fold there."""
    global _session_over
    if values is None or not _recording():
        return
    if _session_over:
        _COUNTS.clear()
        _KEPT.clear()
        _session_over = False
    kept = _COUNTS.setdefault(name, [])
    kept.append(values)
    _KEPT[name] = _KEPT.get(name, 0) + values.numel()
    if _KEPT[name] > COUNT_KEEP:
        kept[:] = [torch.cat([t.reshape(-1) for t in kept]).sum(dtype=torch.float64)]
        _KEPT[name] = 1


def counters() -> Dict[str, float]:
    """Each counter's total over the newest traced session (read once the
    session has ended: it waits for the device)."""
    _recording()
    return {name: float(sum(float(t.sum(dtype=torch.float64)) for t in kept))
            for name, kept in _COUNTS.items()}
