"""``graph_host_us_per_replay`` (``metrics/graph_host_us_per_replay.py``)
in the coordinates cell."""

from gossipbench import harness


def read(ctx):
    return harness.load_module("metrics", "graph_host_us_per_replay").read(ctx)
