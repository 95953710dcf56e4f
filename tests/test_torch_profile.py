"""PyTorch port, the per-stage profile path on the CPU.

``bench_profile.profile_controller`` and ``bench_profile_engine.profile_engine``
run end to end at a small size with ``device="cpu"`` (every kernel wrapper
then runs its plain version). Each report carries every key the JAX
package's profilers (the repository root's ``bench_profile.py`` and
``bench_profile_engine.py``, read from their sources) write on a TPU, with
finite values; the check histograms count every row once. The timing
helpers of ``utils`` are held to the JAX package's on the same calls.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpc_for_av_at_intersection_tpu.utils import timing as jax_timing
from mpc_for_av_at_intersection_tpu_torch import utils
from mpc_for_av_at_intersection_tpu_torch.bench_profile import profile_controller
from mpc_for_av_at_intersection_tpu_torch.bench_profile_engine import profile_engine
from mpc_for_av_at_intersection_tpu_torch.ops import admm_probes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _jax_report_keys(script):
    """The keys a root profiler writes into its report: the initial dict,
    every ``timed("name", ...)`` stage (as ``name_ms``) and every
    ``report["key"]``."""
    src = (REPO / script).read_text()
    keys = set(re.findall(r'"(\w+)":', re.search(r"report = \{(.*?)\}", src, re.S).group(1)))
    keys |= {f"{k}_ms" for k in re.findall(r'timed\(\s*"(\w+)"', src)}
    keys |= set(re.findall(r'report\["(\w+)"\]', src))
    return keys


def _assert_finite(report):
    for key, value in report.items():
        if isinstance(value, bool) or isinstance(value, str):
            continue
        if isinstance(value, dict):
            _assert_finite(value)
        elif isinstance(value, list):
            assert all(math.isfinite(v) for v in value), key
        else:
            assert math.isfinite(value), (key, value)


def test_controller_profile_runs_on_the_cpu():
    before = (admm_probes.admm_iterations.launches, admm_probes.admm_all_rounds.launches)
    report = profile_controller(batch=128, T=5, k_steps=2, reps=1, device="cpu")
    want = _jax_report_keys("bench_profile.py")
    assert {"admm_1round_ms", "admm_all_ms", "condense_k_ms", "ruiz_admm_ms"} <= want
    assert want <= set(report), want - set(report)
    _assert_finite(report)
    assert report["device"] == "cpu" and (report["n"], report["m"]) == (10, 19)
    for key in ("admm_checks_cold_hist", "admm_checks_warm_hist"):
        assert sum(report[key]) == 128 and report[key][0] == 0
    stages = [k for k in report if k.endswith("_ms") and k != "unaccounted_ms"]
    assert all(report[k] > 0 for k in stages)
    assert report["accounted_ms"] == pytest.approx(
        report["reference_ms"] + report["condense_k_ms"] + report["ruiz_admm_ms"]
        + report["polish_ms"])
    assert report["full_tick_solved_share"] >= 0.98
    assert report["admm_kernel"]["flops_per_iter_per_scenario"] == 2 * (100 + 2 * 190) + 8 * 29
    assert "TPU" not in str(report) and "v5e" not in str(report)
    assert (admm_probes.admm_iterations.launches, admm_probes.admm_all_rounds.launches) == before


def test_engine_profile_runs_on_the_cpu():
    report = profile_engine(batch=8, warm_ticks=2, k_steps=2, reps=1, device="cpu")
    want = _jax_report_keys("bench_profile_engine.py")
    assert {"predict_ms", "resample_plus_conflict_ms", "conflict_ms", "post_ms"} <= want
    assert want <= set(report), want - set(report)
    _assert_finite(report)
    assert report["batch"] == 8
    assert report["conflict_ms"] == pytest.approx(
        report["resample_plus_conflict_ms"] - report["resample_ms"])
    assert report["ticks_per_s_implied"] == pytest.approx(8 / (report["full_tick_ms"] / 1e3))


def test_time_chained_and_fetch():
    x = torch.arange(6.0).reshape(2, 3)
    assert utils.fetch_scalar(x) == 15.0
    assert utils.measure_fetch_cost(x, n=2) >= 0.0
    dt, carry = utils.time_chained(lambda c: (c[0] + 1, c[1]), (x, "tag"), 3)
    assert dt > -1e-3
    torch.testing.assert_close(carry[0], x + 3)


def test_timing_records_match_jax(tmp_path, capsys):
    """The same calls through both packages' ``utils.timing`` give the same
    labels and counts; ``device_profile`` writes a Chrome trace."""
    summaries = []
    for mod in (jax_timing, utils.timing):
        mod.reset_timing()

        @mod.measure_time(name="work")
        def work(v):
            return v * 2

        assert work(3) == 6 and work(4) == 8
        with mod.timed("block"):
            np.ones(10).sum()
        summaries.append({k: v["n"] for k, v in mod.timing_summary().items()})
        mod.reset_timing()
        assert mod.timing_summary() == {}
    assert summaries[0] == summaries[1] == {"work": 2, "block": 1}
    assert capsys.readouterr().out.count("[timing] work:") == 4
    with utils.device_profile(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
