"""Device: the most memory the program's tensors held during the measured
window (``torch.cuda.max_memory_allocated`` after a reset at its start),
in GiB."""


def read(ctx):
    peak = ctx["peak_window_bytes"]
    return peak / 2**30 if peak else None
