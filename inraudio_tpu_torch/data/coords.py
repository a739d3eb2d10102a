"""Coordinate grids (port of ``inraudio_tpu/data/coords.py``; host numpy,
identical values)."""

from __future__ import annotations

import numpy as np


def get_coord(sidelen: int, dim: int = 2, scale: float = 1.0) -> np.ndarray:
    """A dim-dimensional meshgrid of ``linspace(-scale, scale, sidelen)``
    flattened to (sidelen**dim, dim) float32."""
    axes = [np.linspace(-scale, scale, sidelen, dtype=np.float32)] * dim
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return np.ascontiguousarray(grid.reshape(-1, dim))
