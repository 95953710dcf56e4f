"""End to end: the 95th percentile over every tick of the window of a
tick's time on the stream, from the end of the tick before to the end of
this one (CUDA events), in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["window"]["tick_ms"], 95))
