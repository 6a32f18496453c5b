"""Agents x protocol periods completed in the window, over the window's
whole wall time: every call of the window, each ending with its results
on the host."""


def read(ctx):
    if not ctx.calls or ctx.wall_s <= 0:
        return None
    return ctx.n * ctx.rounds * ctx.calls / ctx.wall_s
