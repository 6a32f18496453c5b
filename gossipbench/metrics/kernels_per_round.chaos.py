"""``kernels_per_round`` (``metrics/kernels_per_round.py``) in the chaos cell."""

from gossipbench import harness


def read(ctx):
    return harness.load_module("metrics", "kernels_per_round").read(ctx)
