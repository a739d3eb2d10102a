"""The device rule of the package's entry points: they run on the card
unless the caller asks for the CPU, and a card that is not there raises
rather than falling back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
