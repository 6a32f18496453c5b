"""The fast runner's calls: every period on the last period's population
scalars, which the period's own contribution lanes refresh (``sum``
each, clamped); the first period of a call on the state's exact
scalars; threefry draws keyed by the round's key, as the live engine's.

It is not the lane engine at ``stale_k`` 1: that engine draws the
global-index stream and sums in a fixed tree, so on the same key the two
runs part at the first draw."""

import torch

from gossipbench.reference import model, prng
from gossipbench.reference.model import LAT, N_SCALARS, N_STATS

_I32 = torch.int32


def fast_call(s, key, P, rounds: int, F=model.torch.float32):
    """``rounds`` periods on stale scalars from ``model.init_scalars``."""
    keys = prng.round_keys(key, s.round_idx, rounds)
    rows = s.lanes[0].shape[0]
    scalars = model.init_scalars(s, P, F)
    lanes8, t, r, stats = s.lanes, s.t, s.round_idx, list(s.stats)
    for i in range(rounds):
        outs, lanes = model.period(lanes8, scalars, P,
                                   prng.threefry_slots(keys[i], rows), F)
        lanes8 = model._narrow(outs, lanes8)
        if P.collect_stats:
            for j in range(N_STATS):
                lane = lanes[N_SCALARS + j]
                if lane is None:
                    continue
                stats[j] = stats[j] + (torch.sum(lane) if j == LAT else
                                       torch.sum(lane.to(_I32)).to(_I32))
        scalars = model.clamp_scalars(torch.stack(
            [torch.sum(lane) for lane in lanes[:N_SCALARS]]))
        t = t + P.probe_interval
        r = r + 1
    return model.State(lanes8, t, r, tuple(stats))


def call(s, key, P, traffic, scalars0=None, F=model.torch.float32):
    return fast_call(s, key, P, traffic["rounds"], F), None, None
