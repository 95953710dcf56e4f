"""One run of one cell: set-up, the measured window, the traced ticks and
the check, returning the result line.

The window runs episodes of the cell's fixed number of ticks back to back,
each from the fleet's start state, until ``seconds`` have passed on the
host clock; it opens and closes at a synchronization. Inside an episode
nothing synchronizes: a CUDA event is recorded after each tick and read at
the episode's end, where the host waits for the device and counts the
unsolved rows, as a Monte-Carlo study collects an episode's outcome.
"""

from __future__ import annotations

import gc
import time

import torch

from . import generator, judge, spec
from .trace import profile_ticks

TRACE_WARM_TICKS = 2     # ticks before the traced ones, so that these are warm


def device_info(device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Per-tick end events on the card; the host clock elsewhere (the CPU
    runs synchronously, so the two agree there)."""

    def __init__(self, device, n):
        self.cuda = device.type == "cuda"
        self.pools = [[self._event() for _ in range(n)] for _ in range(2)]
        self.start = self._event()

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else [0.0]

    def record(self, ev):
        if self.cuda:
            ev.record()
        else:
            ev[0] = time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b[0] - a[0]) * 1e3


def run_window(fleet, seconds, draws, device, max_ticks=None):
    """The measured window (or its first ``max_ticks`` ticks). Returns its
    record and the captures of the drawn ticks of its first episode."""
    n = fleet.episode_ticks
    clock = Clock(device, n)
    host_s, tick_ms, captures = [], [], {}
    ticks = failed = episodes = 0
    sync(device)
    t0 = time.perf_counter()
    clock.record(clock.start)
    prev = clock.start
    stop = False
    while not stop:
        pool = clock.pools[episodes % 2]
        st, flags = fleet.state0, []
        for k in range(n):
            h0 = time.perf_counter()
            new, tel = fleet.tick(st)
            host_s.append(time.perf_counter() - h0)
            clock.record(pool[k])
            flags.append(tel.solved)
            if episodes == 0 and k in draws:
                captures[k] = (st, new, tel)
            st = new
            ticks += 1
            if time.perf_counter() - t0 >= seconds or ticks == max_ticks:
                stop = True
                break
        sync(device)
        for ev in pool[:len(flags)]:
            tick_ms.append(clock.ms(prev, ev))
            prev = ev
        failed += int((~torch.stack(flags)).sum())
        episodes += 1
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "ticks": ticks, "episodes": episodes, "host_s": host_s,
            "tick_ms": tick_ms, "failed": failed, "attempted": ticks * fleet.rows}, captures


def run_cell(name, seed, seconds, trace, device, t_start, cell=None):
    """Everything of one run but the look for a chip and the import check.
    Returns (result line without "check", check numbers shown, stderr
    lines)."""
    cell = cell or spec.cell(name)
    config, traffic_p, check = cell["config"], cell["traffic"], cell["check"]
    fleet = generator.build(traffic_p, config, seed, device)
    draws = judge.draw(check, fleet.episode_ticks, fleet.rows, seed)

    # warm-up at the cell's shapes: the cold tick, then warm ones
    st = fleet.state0
    for _ in range(traffic_p["warm_ticks"]):
        st, _ = fleet.tick(st)
    sync(device)
    del st
    setup_s = time.perf_counter() - t_start

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec, captures = run_window(fleet, seconds, draws, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    rows, ticks = fleet.rows, rec["ticks"]
    info = device_info(device)
    info["memory_peak_bytes"] = int(peak)
    result = {"correct": False, "attempted": rec["attempted"], "failed": rec["failed"]}
    lines = [f"window {rec['window_s']:.3f} s, {ticks} ticks in {rec['episodes']} episodes of "
             f"{fleet.episode_ticks}, {rows} ego rows a tick; set-up {setup_s:.3f} s"]

    ctx = {"window": rec, "setup_s": setup_s, "peak_window_bytes": peak, "fleet": fleet,
           "config": config, "library_kernels": spec.library_kernels()}
    if trace:
        st = fleet.state0
        for _ in range(TRACE_WARM_TICKS):
            st, _ = fleet.tick(st)
        tr = profile_ticks(fleet, st, traffic_p["trace_ticks"], name)
        del st
        ctx["trace"] = tr
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        lines.append(f"trace of {tr.ticks} ticks: {tr.path} ({tr.nbytes / 2**20:.1f} MiB)")
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    del ctx
    result["metrics"] = metrics
    result["device"] = info

    # the check, once the window has closed and its peak is read: only the
    # captured ticks stay
    world, kind = fleet.world, fleet.kind
    del fleet
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge.judge(kind, world, captures, draws, config, device)
    correct, shown = judge.verdict(numbers, check["limits"])
    result["correct"] = correct
    lines.append(f"check: {len(captures)} ticks of {len(draws)} drawn; "
                 + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()
                             if isinstance(v, (int, float)))
                 + f"; {time.perf_counter() - t_check:.1f} s")
    return result, shown, lines
