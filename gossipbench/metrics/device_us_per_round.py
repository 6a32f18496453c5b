"""Device-busy microseconds (the union of the device's intervals) in
the traced window, over the periods the window ran."""


def read(ctx):
    if not ctx.dev or not ctx.traced_rounds:
        return None
    return ctx.busy_s * 1e6 / ctx.traced_rounds
