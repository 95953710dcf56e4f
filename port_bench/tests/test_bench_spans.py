"""The readers of the program's spans and counters (``spans.py``, the
stage metrics, ``k2_checks_per_row``, ``k2_counted_roofline``) on a
Chrome trace made up by hand: the window, nested spans on one host thread
and a span on another, launches through the runtime and the driver with
their ``correlation``, kernels, a copy and a fill, and a copy launched
outside every span. Each reader returns its exact value; the stages'
launches with K1's and K2's kernels are ``launches_per_tick``; K2's
counted work is pinned at T=13 by hand. CPU only.

    python -m pytest port_bench/tests -q
"""

import json
from types import SimpleNamespace

import pytest

from mpc_for_av_at_intersection_tpu_torch.utils import timing
from port_bench import spans, spec
from port_bench.roofline import bound_ms, k2_counts
from port_bench.trace import WINDOW, Trace

TICKS = 2
ROWS = 10
STAGES = ("predict", "scan", "pre_self", "mpc_torch", "post")
MAIN, OTHER = (1, 7), (1, 8)      # (pid, tid) of two host threads

# (name, start, end) of the program's spans on the main thread
SPANS = [("tick.predict", 20, 100), ("tick.pre", 110, 400),
         ("pre.scan", 150, 300), ("tick.mpc", 410, 700), ("mpc.k1", 450, 480),
         ("mpc.k2", 500, 550), ("tick.post", 710, 890)]
# (launch category, launch start, device category, device name, device us)
LAUNCHES = [
    ("cuda_runtime", 30, "kernel", "elementwise_kernel", 10),    # tick.predict
    ("cuda_runtime", 60, "kernel", "elementwise_kernel", 5),     # tick.predict
    ("cuda_runtime", 120, "kernel", "index_kernel", 7),          # tick.pre
    ("cuda_runtime", 200, "kernel", "elementwise_kernel", 20),   # pre.scan
    ("cuda_runtime", 250, "gpu_memcpy", "Memcpy DtoD", 4),       # pre.scan
    ("cuda_runtime", 420, "gpu_memset", "Memset", 2),            # tick.mpc
    ("cuda_runtime", 430, "kernel", "reduce_kernel", 3),         # tick.mpc
    ("cuda_driver", 460, "kernel", "build_qp_kernel", 30),       # mpc.k1
    ("cuda_driver", 510, "kernel", "void solve_polish_kernel<BucketT13>", 100),  # mpc.k2
    ("cuda_runtime", 720, "kernel", "elementwise_kernel", 6),    # tick.post
    ("cuda_runtime", 905, "gpu_memcpy", "Memcpy DtoH", 8),       # no span
]
WANT_US = {"predict": 15, "scan": 24, "pre_self": 7, "mpc_torch": 5, "post": 6}
WANT_KERNELS = {"predict": 2, "scan": 1, "pre_self": 1, "mpc_torch": 1, "post": 1}
CHECKS, FACTORIZATIONS = 130.0, 45.0
MPC = {"T": 13, "admm_check_iters": 32, "admm_ruiz_iters": 3, "max_iter": 1}


def _events():
    def x(cat, name, ts, dur, where=MAIN, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": where[0], "tid": where[1],
                "ts": float(ts), "dur": float(dur), "args": args}

    ev = [x("user_annotation", WINDOW, 0, 1000)]
    ev += [x("user_annotation", n, a, b - a) for n, a, b in SPANS]
    ev.append(x("user_annotation", "other", 0, 1000, where=OTHER))
    for corr, (lcat, ts, dcat, name, dur) in enumerate(LAUNCHES, start=100):
        ev.append(x(lcat, "launch", ts, 2, correlation=corr))
        ev.append(x(dcat, name, ts + 3, dur, where=(0, 7), correlation=corr))
    # a runtime call with no device activity, and device activity after
    # the window
    ev.append(x("cuda_runtime", "cudaStreamSynchronize", 895, 100, correlation=99))
    ev.append(x("kernel", "late_kernel", 1200, 5, where=(0, 7), correlation=98))
    return ev


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    path = tmp_path / "made_up.trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    tr = Trace(_events(), TICKS)
    tr.path = path
    monkeypatch.setattr(timing, "counters",
                        lambda: {"k2.checks": CHECKS, "k2.factorizations": FACTORIZATIONS})
    return {"trace": tr, "fleet": SimpleNamespace(rows=ROWS), "config": {"mpc": MPC},
            "library_kernels": spec.library_kernels()}


@pytest.mark.parametrize("stage", STAGES)
def test_each_stage_reader_returns_its_spans_own_share(ctx, stage):
    assert spec.reader(f"{stage}_ms_per_tick")(ctx) == pytest.approx(
        WANT_US[stage] * 1e-3 / TICKS, rel=1e-12)
    assert spec.reader(f"{stage}_launches_per_tick")(ctx) == WANT_KERNELS[stage] / TICKS


def test_a_span_on_another_thread_takes_nothing_and_children_their_own(ctx):
    assert spans.charged(ctx, "other") == (0.0, 0)
    assert spans.charged(ctx, "mpc.k1") == (30.0, 1)
    assert spans.charged(ctx, "mpc.k2") == (100.0, 1)
    assert spans.charged(ctx, "no.such.span") is None


def test_the_stages_with_k1_and_k2_are_the_ticks_launches(ctx):
    tr = ctx["trace"]
    k1 = sum("build_qp_kernel" in k[0] for k in tr.kernels())
    k2 = sum("solve_polish_kernel" in k[0] for k in tr.kernels())
    stages = sum(spec.reader(f"{s}_launches_per_tick")(ctx) for s in STAGES)
    assert stages + (k1 + k2) / TICKS == spec.reader("launches_per_tick")(ctx)


def test_the_stages_ms_leave_out_only_what_no_span_launched(ctx):
    stages = sum(spec.reader(f"{s}_ms_per_tick")(ctx) for s in STAGES)
    outside = 8e-3 / TICKS       # the copy launched outside every span
    assert stages + outside == pytest.approx(spec.reader("torch_ops_ms_per_tick")(ctx))


def test_k2_checks_per_row_reads_the_programs_counter(ctx):
    assert spec.reader("k2_checks_per_row")(ctx) == CHECKS / (ROWS * TICKS)


def test_k2_counted_roofline_is_the_counted_works_least_time_over_k2s(ctx):
    ops = spec._module("metrics", "k2_counted_roofline").counted_ops(
        ROWS * TICKS, 26, 51, 32, 3, FACTORIZATIONS, CHECKS)
    nbytes, _ = k2_counts(ROWS * TICKS, 26, 51, 32, 3)
    least, _ = bound_ms(nbytes / TICKS, ops / TICKS)
    got = spec.reader("k2_counted_roofline")(ctx)
    assert got == pytest.approx(100.0 * least / (100e-3 / TICKS))
    assert got > spec.reader("k2_roofline")(ctx)


def test_k2_counted_operations_at_t13():
    counted_ops = spec._module("metrics", "k2_counted_roofline").counted_ops
    # a row: Ruiz 9 (676 + 1326), G'G 51 * 676, the polish's first attempt
    # 26^3 / 3 + 2 * 676 + 2 * 1326 + 2 (4 * 676 + 4 * 1326)
    row = 18018 + 34476 + 26 ** 3 / 3 + 1352 + 2652 + 16016
    factorize = 676 + 26 ** 3                     # M, then L, L^-1 and L^-T L^-1
    block = 32 * (1352 + 5304 + 510) + 1352 + 5304
    assert counted_ops(1, 26, 51, 32, 3, 2, 5) == pytest.approx(row + 2 * factorize + 5 * block)
    # one factorization and one block a row is the least work, with the
    # factorization's inverse and M on top of its Cholesky
    _, least = k2_counts(4, 26, 51, 32, 3)
    assert counted_ops(4, 26, 51, 32, 3, 4, 4) == pytest.approx(
        least + 4 * (2 * 26 ** 3 / 3 + 676))


def test_readers_of_a_program_without_spans_or_counters_give_none(ctx, tmp_path, monkeypatch):
    bare = [e for e in _events() if e["cat"] != "user_annotation" or e["name"] == WINDOW]
    path = tmp_path / "bare.trace.json"
    path.write_text(json.dumps({"traceEvents": bare}))
    ctx["trace"].path = path
    monkeypatch.delattr(timing, "counters")
    for name in [f"{s}_{k}_per_tick" for s in STAGES for k in ("ms", "launches")] + [
            "k2_checks_per_row", "k2_counted_roofline"]:
        assert spec.reader(name)(ctx) is None, name
