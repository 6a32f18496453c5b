"""``device_us_per_round`` (``metrics/device_us_per_round.py``) in the
coordinates cell."""

from gossipbench import harness


def read(ctx):
    return harness.load_module("metrics", "device_us_per_round").read(ctx)
