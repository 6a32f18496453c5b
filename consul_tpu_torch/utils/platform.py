"""Device choice for the port's entry points.

The port runs on the CUDA card. A caller that wants the host asks for it
by name (``device="cpu"``, as the CPU tests do); nothing falls back to
the CPU because a card is missing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class NoCudaDeviceError(RuntimeError):
    """The default (card) device was requested on a host without one."""


def default_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` and ``"cuda"`` mean the card and raise
    ``NoCudaDeviceError`` when ``torch.cuda.is_available()`` is false;
    ``"cpu"`` (or any explicit CPU device) is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "consul_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    return dev


def device_name(device: Optional[torch.device] = None) -> str:
    """Human-readable name of the device a result was computed on."""
    dev = default_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
