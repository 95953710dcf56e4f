"""Wall-clock records and a device profile capture.

Port of ``mpc_for_av_at_intersection_tpu/utils/timing.py``: the reference's
``@measure_time`` decorator, a context manager, aggregate statistics, and
``device_profile``, which records a ``torch.profiler`` trace (CPU and, where
a card is present, CUDA activity) and writes it as a Chrome trace.
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
