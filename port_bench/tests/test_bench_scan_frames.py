"""The reader ``scan_frames_per_row`` on made-up counters: the program's
``scan.frames`` over the rows of the traced ticks, and None for a program
without the counter (one that counts K2's work but not the scan's frames,
or keeps no counters). CPU only.

    python -m pytest port_bench/tests -q
"""

from types import SimpleNamespace

from mpc_for_av_at_intersection_tpu_torch.utils import timing
from port_bench import spec

TICKS, ROWS, FRAMES = 3, 10, 170.0
K2 = {"k2.checks": 130.0, "k2.factorizations": 45.0}


def _ctx():
    return {"trace": SimpleNamespace(ticks=TICKS), "fleet": SimpleNamespace(rows=ROWS)}


def test_scan_frames_per_row_reads_the_programs_counter(monkeypatch):
    monkeypatch.setattr(timing, "counters", lambda: dict(K2, **{"scan.frames": FRAMES}))
    assert spec.reader("scan_frames_per_row")(_ctx()) == FRAMES / (ROWS * TICKS)


def test_scan_frames_per_row_of_a_program_without_the_counter_is_none(monkeypatch):
    monkeypatch.setattr(timing, "counters", lambda: dict(K2))
    assert spec.reader("scan_frames_per_row")(_ctx()) is None
    monkeypatch.delattr(timing, "counters")
    assert spec.reader("scan_frames_per_row")(_ctx()) is None
