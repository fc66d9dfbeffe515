"""The device an entry point of the port runs on."""
from __future__ import annotations

from typing import Optional, Union

import torch

# Steps of a data-dependent loop on the device (Lloyd, label propagation)
# between the host's checks that it has stopped: a step after the stop is an
# exact no-op, so the host syncs every POLL_EVERY steps instead of each.
POLL_EVERY = 8


def resolve_device(device: Optional[Union[str, torch.device]], what: str) -> torch.device:
    """`device`, or CUDA when it is None: the port's entry points run on the
    card unless the caller asks for the CPU. A CUDA device on a host without
    a card raises RuntimeError; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device {str(dev)!r} requested but CUDA is not available "
                           f"(pass device='cpu' to run on the CPU)")
    return dev
