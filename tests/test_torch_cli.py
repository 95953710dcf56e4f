"""PyTorch port: the command-line interface against the JAX package's.

Each subcommand runs in this process with ``--device cpu`` at a small size
and prints the JSON keys of the JAX CLI's same subcommand:

- ``run --driver intersection --steps 110``: JAX's ``run`` (its drivers
  planning with the Python search) gives the same ``done`` and
  ``ticks_to_goal`` (101) and no unsolved tick; ``--save-telemetry``,
  ``--plot`` and ``--live-save`` write their files;
- ``plan``: JAX's cost and expansions exactly, with the port's native core
  and with its Python search;
- ``fleet`` and ``sweep``: the keys of the dicts the JAX CLI prints (read
  from its source: running them through JAX adds nothing the parity tests
  of the fleet and the sweep do not hold), the sweep run to the goal at
  every weight, tighter tracking at the larger weight; ``fleet --shard``
  under torchrun (two gloo ranks) prints once, the unsharded summary.
- ``--device cuda`` (the default) without a card exits non-zero before
  doing anything; ``bench`` takes the card only; ``bench.run_bench`` runs
  its two measurements at a small size on CPU tensors and names the
  metrics of the root ``bench.py``.
"""

import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu import api as japi
from mpc_for_av_at_intersection_tpu import cli as jcli
from mpc_for_av_at_intersection_tpu_torch import bench, cli

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


def _jax_keys(fn_name):
    """The keys of the JSON object the JAX CLI's subcommand prints: the
    largest dict literal with string keys in the function."""
    tree = ast.parse((REPO / "mpc_for_av_at_intersection_tpu" / "cli.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    dicts = [d for d in ast.walk(fn) if isinstance(d, ast.Dict) and d.keys
             and all(isinstance(k, ast.Constant) and isinstance(k.value, str) for k in d.keys)]
    return [k.value for k in max(dicts, key=lambda d: len(d.keys)).keys]


def test_run_matches_jax(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(japi, "plan_course", functools.partial(japi.plan_course,
                                                               use_native=False))
    want = _run(jcli.main, ["run", "--driver", "intersection", "--steps", "110"], capsys)
    tel = tmp_path / "tel.npz"
    got = _run(cli.main, ["run", "--device", "cpu", "--driver", "intersection", "--steps", "110",
                          "--save-telemetry", str(tel), "--plot", str(tmp_path / "tel.png")],
               capsys)
    assert list(got) == list(want) == _jax_keys("_cmd_run")
    assert got["done"] is want["done"] is True
    assert got["ticks_to_goal"] == want["ticks_to_goal"] == 101
    assert got["unsolved_ticks"] == want["unsolved_ticks"] == 0
    assert got["conflicts_detected"] > 0
    assert abs(got["max_xref_deviation"] - want["max_xref_deviation"]) <= 1e-3
    with np.load(tel) as saved:
        assert saved["x"].shape == (110,) and bool(saved["done"][101])
    assert (tmp_path / "tel.png").stat().st_size > 1000


def test_run_live_save_streams_frames(capsys, tmp_path):
    frames = tmp_path / "frames"
    got = _run(cli.main, ["run", "--device", "cpu", "--steps", "3", "--live-save", str(frames)],
               capsys)
    assert list(got) == _jax_keys("_cmd_run") and got["unsolved_ticks"] == 0
    assert len(list(frames.glob("frame_*.png"))) == 3


@pytest.mark.parametrize("backend", ["native", "python"])
def test_plan_matches_jax(capsys, backend):
    want = _run(jcli.main, ["plan", "--env", "roundabout", "--start", "1", "--turn", "1",
                            "--backend", "python"], capsys)
    got = _run(cli.main, ["plan", "--device", "cpu", "--env", "roundabout", "--start", "1",
                          "--turn", "1", "--backend", backend], capsys)
    assert list(got) == list(want)
    for key in ("env", "cost", "path_nodes", "trajectory_points", "expansions"):
        assert got[key] == want[key], key
    assert got["backend"] == backend


def test_fleet_keys_and_summary(capsys, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    got = _run(cli.main, ["fleet", "--device", "cpu", "--n", "6", "--steps", "4",
                          "--planner", "host", "--shard"], capsys)
    assert list(got) == _jax_keys("_cmd_fleet")
    assert got["n_scenarios"] == 6 and got["unsolved_ticks"] == 0
    assert got["mean_ticks_to_goal"] == 4.0 and got["planner"] == "host"
    assert got["devices"] == 1   # --shard without torchrun: one device


def test_fleet_shards_over_torchrun_ranks(capsys, monkeypatch):
    """``fleet --shard`` under torchrun (two gloo ranks here): rank 0 alone
    prints, the summary of the whole fleet, equal to the unsharded run's."""
    import os
    import subprocess
    import sys

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["fleet", "--device", "cpu", "--n", "4", "--steps", "3", "--planner", "host"]
    want = _run(cli.main, args, capsys)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node=2", "-m", "mpc_for_av_at_intersection_tpu_torch",
                           "--", *args, "--shard"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert got["devices"] == 2 and want["devices"] == 1
    for key in ("n_scenarios", "n_done", "unsolved_ticks", "mean_ticks_to_goal"):
        assert got[key] == want[key], key


def test_sweep_reaches_the_goal(capsys):
    got = _run(cli.main, ["sweep", "--device", "cpu", "--steps", "60", "--values", "1,20"],
               capsys)
    assert [list(r) for r in got] == [_jax_keys("_cmd_sweep")] * 2
    assert [r["value"] for r in got] == [1.0, 20.0]
    assert all(r["done"] and r["ticks_to_goal"] < 60 for r in got)
    assert got[1]["max_deviation"] <= got[0]["max_deviation"]


def test_the_card_is_required(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            cli.main(["run", "--steps", "2"])
        assert exc.value.code != 0
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--device", "cpu"])
    assert exc.value.code not in (0, None)


def test_bench_measurements_at_a_small_size(monkeypatch):
    assert (bench.BATCH, bench.HORIZON, bench.N_COURSE, bench.STEADY_ITERS) == (4096, 20, 512, 20)
    assert (bench.FLEET_SCENARIOS, bench.FLEET_STEPS) == (1024, 32)   # bench.py:18-21, 147
    for name, value in (("BATCH", 8), ("N_COURSE", 64), ("STEADY_ITERS", 2),
                        ("FLEET_SCENARIOS", 4), ("FLEET_STEPS", 2)):
        monkeypatch.setattr(bench, name, value)
    res = bench.run_bench(seed=1, device="cpu")
    line = res["line"]
    assert list(line) == ["metric", "value", "unit", "fleet_scenario_ticks_per_s"]
    assert line["metric"] == "mpc_solves_per_sec_per_chip_T20" and line["value"] > 0
    assert list(bench.run_bench(seed=1, fleet=False, device="cpu")["line"]) == [
        "metric", "value", "unit"]
    if not torch.cuda.is_available():
        assert bench.main() != 0
