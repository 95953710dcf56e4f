"""End to end: the set-up, process start to the window's start, in s."""


def read(ctx):
    return ctx["setup_s"]
