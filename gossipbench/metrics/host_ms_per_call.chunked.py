"""The median host time of a call, from its entry to its return, before
the synchronise and the read: the runner's host path (prologue, graph
replay, the recorder's launches). Read from the window's calls after the
traced ones, which the profiler does not slow."""

import statistics


def read(ctx):
    if not ctx.host_ms:
        return None
    return statistics.median(ctx.host_ms)
