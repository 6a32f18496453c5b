"""The batched SWIM failure-detector simulation in PyTorch.

Main path: packed per-node state (``state``), one protocol period
(``round``), the CUDA round kernels and their runner (``cuda_round``),
and the failure-detector report (``metrics``). Submodules are imported
lazily by their users; importing this package builds nothing.
"""

from consul_tpu_torch.sim.params import SimParams, baseline_configs
from consul_tpu_torch.sim.state import SimState, SimStats, init_state

__all__ = ["SimParams", "SimState", "SimStats", "baseline_configs",
           "init_state"]
