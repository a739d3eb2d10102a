"""MSE (port of ``inraudio_tpu/train/losses.py::mse``; the other losses of
that module are not ported yet)."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))
