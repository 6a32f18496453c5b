"""``lane_round``'s share of its roofline in the sweep cell: the share
``trace.roofline`` reads at the frozen count of one pool of the grid's
``n`` agent-rows (``bounds/lane_round.py``), taken at the grid's own
count instead (``bounds/lane_round_grid.py``: the slot rows are read
once for the pool every point shares)."""

from gossipbench import trace
from gossipbench.bounds import lane_round, lane_round_grid


def read(ctx):
    share = trace.roofline(ctx, "lane_round")
    if share is None:
        return None
    return share * lane_round_grid.bound_s(ctx.cfg, ctx.traffic, ctx.n) \
        / lane_round.bound_s(ctx.cfg, ctx.traffic, ctx.n)
