"""100 x (1 - device-busy time / the traced window's wall time)."""


def read(ctx):
    if not ctx.dev or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
