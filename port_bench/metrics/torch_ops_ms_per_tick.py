"""Pre and post stages, plain torch: device ms a tick of every kernel,
copy and fill that is not one of the program's own CUDA kernels
(``kernels.json``)."""


def read(ctx):
    tr = ctx["trace"]
    ms = tr.ms_per_tick(exclude=ctx["library_kernels"])
    return ms if ms > 0 else None
