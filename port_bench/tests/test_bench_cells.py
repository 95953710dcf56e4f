"""Each cell's run end to end at a tiny size on the CPU (the program's plain
versions in place of its kernels): the reference agrees within the cell's
limits; with the timed path broken underneath (the state returned
unchanged, half of the rows left out, a command altered where it is
produced, every other solve reported unsolved) ``correct`` comes out
false; the bfloat16 control fails the
cell's limits. On the card (``-m cuda``): one short run of each cell
through the command, its last line checked.

    python -m pytest port_bench/tests -q
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from port_bench import calibrate, harness, judge, spec

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CPU = torch.device("cpu")
SEED = 3_000_000_019          # past 32 signed bits, as the driver's seeds are


def tiny_cell(name):
    """The cell with its fleet cut to a few rows and short episodes."""
    cell = spec.cell(name)
    tr = cell["traffic"]
    spec.kind(tr["kind"]).shrink(tr)
    tr.update(episode_ticks=8, warm_ticks=1)
    cell["check"].update(rows=6, ticks=3)
    return cell


def run_tiny(name, seed=SEED):
    return harness.run_cell(name, seed, 0.5, False, CPU, time.perf_counter(), tiny_cell(name))


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_and_agrees_with_the_reference(name):
    result, shown, _ = run_tiny(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(result["metrics"]) == {m["name"] for m in spec.cell(name)["end_to_end"]}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(shown) == set(spec.cell(name)["check"]["limits"])
    assert result["correct"], shown


def test_finished_rows_agree_with_the_reference():
    """Late ticks, where rows have reached their goal and freeze."""
    import numpy as np

    from port_bench import generator

    cell = spec.cell("T13.fleet10000")
    cell["traffic"].update(scenarios=24, episode_ticks=124)
    fleet = generator.build(cell["traffic"], cell["config"], SEED, CPU)
    draws = {t: np.arange(fleet.rows) for t in (100, 123)}
    _, captures = harness.run_window(fleet, float("inf"), draws, CPU, max_ticks=124)
    numbers = judge.judge(fleet.kind, fleet.world, captures, draws, cell["config"], CPU)
    done = sum(int(c[2].done.sum()) for c in captures.values())
    assert done > 0, "no row finished: the test would not see a frozen row"
    assert judge.verdict(numbers, cell["check"]["limits"])[0], numbers


def _kind(name):
    return spec.kind(spec.cell(name)["traffic"]["kind"])


def _state_unchanged(tick):
    def broken(world, st, cfg, geom, *a):
        _, tel = tick(world, st, cfg, geom, *a)
        return st, tel
    return broken


def _half_left_out(tick):
    """The first half of the rows (scenarios or junctions) ticks; the rest
    keep their state."""
    def mix(n, o):
        if isinstance(n, tuple):
            return type(n)(*(mix(a, b) for a, b in zip(n, o)))
        half = n.shape[0] // 2 if n.dim() else 0
        return torch.cat([n[:half], o[half:]]) if half else n

    def broken(world, st, cfg, geom, *a):
        new, tel = tick(world, st, cfg, geom, *a)
        return mix(new, st), tel
    return broken


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "command_altered",
                                   "unsolved_reported"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    import importlib

    kind = _kind(name)
    if fault == "unsolved_reported":
        undo = calibrate.unsolved_half(kind)
        try:
            result, shown, _ = run_tiny(name)
        finally:
            undo()
        assert not result["correct"], shown
        assert shown["unsolved_share"]["value"] > shown["unsolved_share"]["limit"], shown
        return
    if fault == "command_altered":
        mod_name, fns = kind.SOLVER_SITES
        mod = importlib.import_module(f"mpc_for_av_at_intersection_tpu_torch.{mod_name}")
        for fn in fns:
            def altered(*a, _step=getattr(mod, fn)):
                out = _step(*a)
                return out._replace(accel=out.accel + 1.0)

            monkeypatch.setattr(mod, fn, altered)
    else:
        mod_name, attr = kind.ENTRY
        mod = importlib.import_module(f"mpc_for_av_at_intersection_tpu_torch.{mod_name}")
        wrap = _state_unchanged if fault == "state_unchanged" else _half_left_out
        monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    result, shown, _ = run_tiny(name)
    assert not result["correct"], shown


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_fails_the_cells_limits(name):
    r = calibrate.readings(name, SEED, CPU, True, tiny_cell(name))
    ok, shown = judge.verdict(r["control"], spec.cell(name)["check"]["limits"])
    assert not ok, shown
    ok, shown = judge.verdict(r["program"], spec.cell(name)["check"]["limits"])
    assert ok, shown


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", name,
                        "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"], line["check"]
    assert line["device"]["busy_s"] > 0
