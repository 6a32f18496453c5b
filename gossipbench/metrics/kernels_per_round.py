"""Device operations (kernels, copies, fills) the profiler saw in the
traced window, over the periods the window ran."""


def read(ctx):
    if not ctx.dev or not ctx.traced_rounds:
        return None
    return len(ctx.dev) / ctx.traced_rounds
