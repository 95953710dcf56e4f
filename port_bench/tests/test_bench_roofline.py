"""The roofline arithmetic pinned at one shape (B=1, T=13: n=26, m=51) to
counts worked by hand, and the trace arithmetic on a made-up timeline."""

import pytest

from port_bench import roofline
from port_bench.trace import WINDOW, Trace


def test_k1_counts_at_t13():
    # bytes: 4 (4 + 26 + 56) + 14 in; 4 (676 + 26 + 1326 + 102 + 1352 + 52) out
    # operations: 26*13*32 + 338*13*20 + 26*13*20 + 200*13
    assert roofline.k1_counts(1, 13) == (358 + 14136, 10816 + 87880 + 6760 + 2600)


def test_k2_least_counts_at_t13():
    nbytes, ops = roofline.k2_counts(1, 26, 51, check_iters=32, ruiz_iters=3)
    # P, q, G, lo, hi (2130), warm x, y, rho (78), x, y and four scalars (81)
    assert nbytes == 4 * 2289
    ruiz, gram, chol = 9 * (676 + 1326), 51 * 676, 26 ** 3 / 3
    block = 32 * (2 * 676 + 4 * 1326 + 10 * 51) + 2 * 676 + 4 * 1326
    polish = chol + 2 * 676 + 2 * 1326 + 2 * (4 * 676 + 4 * 1326)
    assert ops == pytest.approx(ruiz + gram + chol + block + polish)
    assert ops == pytest.approx(320199.3333333)


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")


def _events():
    win = {"name": WINDOW, "ph": "X", "cat": "user_annotation", "ts": 0.0, "dur": 1000.0}
    kernels = [("build_qp_kernel", 100, 100), ("void solve_polish_kernel<BucketT13>", 300, 300),
               ("elementwise_kernel", 700, 100)]
    ev = [win] + [{"name": n, "ph": "X", "cat": "kernel", "ts": float(t), "dur": float(d)}
                  for n, t, d in kernels]
    ev += [{"name": "aten::cat", "ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 150.0},
           {"name": "aten::where", "ph": "X", "cat": "cpu_op", "ts": 590.0, "dur": 60.0}]
    return ev


def test_trace_busy_share_and_times_per_tick():
    tr = Trace(_events(), ticks=2)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(500e-6)
    assert tr.ms_per_tick(names=("solve_polish_kernel",)) == pytest.approx(0.15)
    assert tr.ms_per_tick(exclude=("build_qp_kernel", "solve_polish_kernel")) == \
        pytest.approx(0.05)
    assert len(tr.kernels()) == 3


def test_idle_gaps_go_to_the_host_operator_open_in_their_middle():
    gaps = dict(Trace(_events(), ticks=1).idle_gaps())
    # [0,100): aten::cat; [200,300): none open; [600,700): aten::where; [800,1000): none
    assert gaps["aten::cat"] == pytest.approx(100e-6)
    assert gaps["aten::where"] == pytest.approx(100e-6)
    assert gaps["host outside any operator"] == pytest.approx(300e-6)
