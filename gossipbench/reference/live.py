"""The live engine's calls: every period on its own population
scalars."""

from gossipbench.reference import model


def call(s, key, P, traffic, scalars0=None, F=model.torch.float32):
    return model.live_call(s, key, P, traffic["rounds"], F), None, None
