"""Seconds from the process's start to the window's first request: imports,
the CUDA context, the cached nvcc and g++ libraries, the weights, warm-up,
the server and the load generator's connections."""


def read(ctx):
    return ctx.setup_s
