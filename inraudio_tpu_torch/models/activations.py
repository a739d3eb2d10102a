"""Snake activation (port of ``inraudio_tpu/models/activations.py``)."""

from __future__ import annotations

import torch


def snake_init(features: int, a_initial: float | None = 0.5,
               generator: torch.Generator | None = None,
               device: torch.device | str = "cpu",
               leading: tuple[int, ...] = ()) -> torch.Tensor:
    """Per-feature ``a``: constant ``a_initial``, or Exponential(0.1) drawn
    from ``generator`` when ``a_initial`` is None.  ``leading`` prepends
    axes (a window axis for stacked parameters)."""
    shape = (*leading, features)
    if a_initial is not None:
        return torch.full(shape, float(a_initial), dtype=torch.float32,
                          device=device)
    a = torch.empty(shape, dtype=torch.float32)
    a.exponential_(1.0, generator=generator)
    return (a * 0.1).to(device)


def snake_apply(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x + (1/a) sin^2(a x)`` in the double-angle form
    ``x + (0.5/a)(1 - cos 2ax)``, as the reference evaluates it."""
    x = x.to(torch.float32)
    return x + (0.5 / a) * (1.0 - torch.cos(2.0 * a * x))
