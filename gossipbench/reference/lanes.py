"""The lane engine's calls: windows of ``stale_k`` periods on scalars
frozen from one fixed-order reduction."""

from gossipbench.reference import model


def call(s, key, P, traffic, scalars0=None, F=model.torch.float32):
    return model.lanes_call(s, key, P, traffic["rounds"], F), None, None
