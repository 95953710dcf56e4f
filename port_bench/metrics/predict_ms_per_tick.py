"""Predictions: device ms a tick of the kernels, copies and fills launched in
the span ``tick.predict``: the scripted agents' states and the constant-
control predictions of every obstacle (in the multi-ego fleet, of the peer
egos too)."""

from port_bench import spans


def read(ctx):
    return spans.ms_per_tick(ctx, "tick.predict")
