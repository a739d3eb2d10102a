"""The KAN in plain float32 PyTorch, after senyuanfan/inr-for-audio kan.py
(efficient-kan's ``KANLinear`` and ``KAN``), and its initial weights drawn
on the device from the run's seed.

Each layer: silu(x) @ base_w.T + b_splines(x).flatten @ (spline_w *
spline_scaler).T, with degree-``spline_order`` Cox-de-Boor bases on a
per-input-feature knot grid of ``grid_size + 2 order + 1`` knots.  The
parameter tree holds, per layer, ``base_w`` (out, in), ``spline_w`` (out,
in, grid + order), ``spline_scaler`` (out, in) and the ``grid`` buffer (in,
knots), as the port's.

Initial weights (``reset_parameters``): base_w and spline_scaler
kaiming-uniform with a = sqrt(5) scale (bound sqrt(1 / (1 + 5 scale^2))
sqrt(6 / in)), and spline_w the least-squares (min-norm) spline through
(rand - 1/2) scale_noise / grid_size at the grid's interior knots
(``curve2coeff``).

Departures: the grid is computed in float64 and rounded once (kan.py
computes it in float32); the random numbers come from one ``torch.rand``
call on the device; ``curve2coeff``'s solve is one pseudo-inverse of the
(grid + 1, grid + order) basis matrix, which is the same for every input
feature on the uniform grid, applied to the noise on the device (the
min-norm solution that kan.py's ``lstsq`` gives).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import matmul


def _grid(cfg: dict, din: int) -> np.ndarray:
    lo, hi = cfg["grid_range"]
    h = (hi - lo) / cfg["grid_size"]
    k = np.arange(-cfg["spline_order"],
                  cfg["grid_size"] + cfg["spline_order"] + 1)
    return np.tile(k * h + lo, (din, 1))


def b_splines(x: torch.Tensor, grid: torch.Tensor,
              order: int) -> torch.Tensor:
    """(batch, in) -> (batch, in, grid_size + order), kan.py's recursion."""
    x = x.unsqueeze(-1)
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, order + 1):
        bases = ((x - grid[:, :-(k + 1)])
                 / (grid[:, k:-1] - grid[:, :-(k + 1)]) * bases[:, :, :-1]
                 + (grid[:, k + 1:] - x)
                 / (grid[:, k + 1:] - grid[:, 1:-k]) * bases[:, :, 1:])
    return bases


def _np_b_splines(x: np.ndarray, grid: np.ndarray, order: int) -> np.ndarray:
    """float64 bases of the points ``x`` on one feature's knots."""
    x = x[:, None]
    bases = ((x >= grid[:-1]) & (x < grid[1:])).astype(np.float64)
    for k in range(1, order + 1):
        bases = ((x - grid[:-(k + 1)]) / (grid[k:-1] - grid[:-(k + 1)])
                 * bases[:, :-1]
                 + (grid[k + 1:] - x) / (grid[k + 1:] - grid[1:-k])
                 * bases[:, 1:])
    return bases


def init(cfg: dict, generator: torch.Generator,
         device: torch.device) -> dict:
    """The initial parameter tree, its random numbers drawn in one call
    from ``generator`` (a generator on ``device``)."""
    g, k = cfg["grid_size"], cfg["spline_order"]
    dims = list(zip(cfg["layers_hidden"][:-1], cfg["layers_hidden"][1:]))
    total = sum(2 * o * i + (g + 1) * i * o for i, o in dims)
    u = torch.rand(total, generator=generator, device=device,
                   dtype=torch.float32)
    layers, off = [], 0
    for din, dout in dims:
        grid = _grid(cfg, din)
        interior = grid[0, k:-k]
        pinv = np.linalg.pinv(_np_b_splines(interior, grid[0], k))
        pinv_t = torch.tensor(pinv, dtype=torch.float32, device=device)

        def kaiming(scale: float, n: int):
            a = math.sqrt(5.0) * scale
            bound = math.sqrt(2.0 / (1.0 + a * a)) * math.sqrt(3.0 / din)
            return (u[off:off + n] * 2.0 - 1.0) * bound

        base_w = kaiming(cfg["scale_base"], dout * din).view(dout, din)
        off += dout * din
        scaler = kaiming(cfg["scale_spline"], dout * din).view(dout, din)
        off += dout * din
        noise = ((u[off:off + (g + 1) * din * dout] - 0.5)
                 * (cfg["scale_noise"] / g)).view(g + 1, din, dout)
        off += (g + 1) * din * dout
        # spline_w[o, i, c] = sum_p pinv[c, p] noise[p, i, o]
        spline_w = torch.einsum("cp,pio->oic", pinv_t, noise)
        layers.append({
            "base_w": base_w.contiguous(), "spline_w": spline_w.contiguous(),
            "spline_scaler": scaler.contiguous(),
            "grid": torch.tensor(grid, dtype=torch.float32, device=device)})
    return {"layers": layers}


def forward(params: dict, cfg: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """(n, in) -> (n, out) in float32 (``tf32``: every product's operands
    rounded to TF32, the control)."""
    for p in params["layers"]:
        base = matmul(torch.nn.functional.silu(x), p["base_w"].T, tf32)
        bases = b_splines(x, p["grid"].detach(), cfg["spline_order"])
        sw = p["spline_w"] * p["spline_scaler"].unsqueeze(-1)
        spline = matmul(bases.reshape(x.shape[0], -1),
                        sw.reshape(sw.shape[0], -1).T, tf32)
        x = base + spline
    return x


def frozen(params: dict) -> set[str]:
    """The knot grids: buffers, no gradient."""
    return {f"layers.{i}.grid" for i in range(len(params["layers"]))}
