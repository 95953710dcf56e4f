"""Finds everything of a cell by the names in ``BENCHMARK.json``: the cell,
its configuration's file, its traffic file (``traffic/<traffic>.json``),
the module of the traffic's kind (``kinds/<kind>.py``), its check file
(``workloads/<cell>.json``), the reference its configuration names
(``<reference>.py``) and the reader of each metric, end to end or per
layer (``metrics/<metric>.py``). Adding a cell, a traffic mix, a kind of
traffic, a configuration, a reference or a metric adds files and
entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic, check and
    metrics: {"workload", "config", "traffic", "check", "end_to_end",
    "per_layer"}."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": w,
        "config": load_json(ROOT / configs[w["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "check": load_json(HERE / "workloads" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


_LOADED: dict = {}


def _module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``port_bench``, loaded once."""
    path = HERE / folder / f"{name}.py"
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"port_bench_{folder or 'top'}_{name}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def kind(name: str):
    """The module of a traffic kind, ``kinds/<name>.py``: its ``build``,
    ``gather`` and ``shrink``, and a ``judge`` of its own where the
    shared check does not fit it."""
    return _module("kinds", name)


def reference(config: dict):
    """The plain reference the configuration names (``<reference>.py``)."""
    return _module("", config["reference"])


def library_kernels() -> list:
    """Base names of the kernels of the program's own CUDA library."""
    return load_json(HERE / "kernels.json")["kernels"]
