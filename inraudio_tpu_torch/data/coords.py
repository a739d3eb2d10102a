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


def grid_coords_2d(height: int, width: int,
                   width_range=(-1.0, 1.0)) -> np.ndarray:
    """(height * width, 2) float32 grid: rows in [-1, 1], columns in
    ``width_range`` (the spectral (freq, time) targets, and the
    multichannel (time, channel) one, whose single channel sits at 0)."""
    h = np.linspace(-1.0, 1.0, height, dtype=np.float32)
    w = np.linspace(width_range[0], width_range[1], width, dtype=np.float32)
    hg, wg = np.meshgrid(h, w, indexing="ij")
    return np.stack([hg, wg], axis=-1).reshape(height * width, 2)
