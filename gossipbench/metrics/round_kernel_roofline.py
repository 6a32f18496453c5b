"""``round_kernel``'s share of its roofline: the least time one launch needs
(``bounds/round_kernel.py``, the H100's published peaks) over its mean device
time a launch in the traced window."""

from gossipbench import trace


def read(ctx):
    return trace.roofline(ctx, "round_kernel")
