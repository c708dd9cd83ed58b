"""``setup_s``: process start to the window: the inputs made, CUDA and
the kernels loaded (built, in a checkout's first run), the port's
construction and sampling, the warm epoch (host clock)."""


def read(ctx):
    return ctx.timings["setup_s"]
