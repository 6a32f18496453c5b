"""From the start of the benchmark's process to the first timed call:
imports, the CUDA context, the kernels loaded (built, on a checkout's
first run), the initial state, the warm-up calls and their graph
captures."""


def read(ctx):
    return ctx.setup_s
