"""The benchmark's files: every cell, configuration, traffic mix, check and
per-layer metric of ``BENCHMARK.json`` loads by name; the contract's shape
of ``BENCHMARK.json``; the result line's keys; nothing under
``port_bench/`` imports JAX or the JAX package, and the reference imports
nothing of the port. CPU only.

    python -m pytest port_bench/tests -q
"""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from port_bench import run, spec

HERE = Path(__file__).resolve().parent.parent
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/") and len(c["source"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_file_of_a_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell["config"]["name"] == cell["workload"]["config"]
    kind = spec.kind(cell["traffic"]["kind"])
    assert callable(kind.build) and callable(kind.shrink)
    if not hasattr(kind, "judge"):      # the shared check and its numbers
        assert callable(kind.gather)
        assert set(cell["check"]["limits"]) <= {
            "pre_mismatch", "control_gap_max", "control_gap_p99", "control_gap_p90",
            "control_gap_p50", "plant_gap", "unsolved_share"}
    assert callable(spec.reference(cell["config"]).constants)
    assert "setup_s" in [m["name"] for m in cell["end_to_end"]]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_the_result_line_ends_with_the_compared_numbers():
    result = {"correct": True, "attempted": 4, "failed": 0, "metrics": {}, "device": {},
              "breakdown": {"device_ops": [], "idle_gaps": []}}
    line = json.loads(run.result_line(result, {"plant_gap": {"value": 0.0, "limit": 1.0}}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "check"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_port():
    tops = {m.split(".")[0] for m in _imports(HERE / "reference.py")}
    assert tops <= {"__future__", "math", "torch"}, tops


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "mpc_for_av_at_intersection_tpu_torch.engine", json)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "mpc_for_av_at_intersection_tpu.mpc", json)
    assert run.loaded_forbidden() == ["mpc_for_av_at_intersection_tpu"]
