"""consul_tpu_torch — the batched SWIM failure-detector simulation in
PyTorch, with its round kernels written by hand in CUDA C++ for Hopper.

The package mirrors ``consul_tpu``'s paths (``consul_tpu/sim/round.py``
has its counterpart at ``consul_tpu_torch/sim/round.py``) but imports
nothing of it: the jax-free tables it needs (gossip config, layout
registry, simulation params) are kept here as copies. Plain tensor code
is PyTorch; the per-round and R-round protocol kernels live in
``csrc/round_kernels.cu`` and are bound through ``ctypes``
(``utils/build.py``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: without a card they raise instead of silently running
on the host (``utils.platform.default_device``).
"""

from consul_tpu_torch.utils.platform import default_device

__all__ = ["default_device"]
