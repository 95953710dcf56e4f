"""Conflict scan: the frames a row walked in the scan kernel, a row and a
traced tick: up to and with its first hitting frame, all of its
max(n_ego, n_pred) frames where none hits, none where no obstacle is
active. The program's counter ``scan.frames`` over the rows of the traced
ticks (None where the program keeps no such counter)."""

from port_bench import spans


def read(ctx):
    frames = spans.counter("scan.frames")
    return None if frames is None else frames / (ctx["fleet"].rows * ctx["trace"].ticks)
