"""Kolmogorov-Arnold network (efficient-KAN semantics) in plain PyTorch
(port of ``inraudio_tpu/models/kan.py``).

Per layer the output is

    silu(x) @ base_w.T  +  b_splines(x).reshape(batch, -1) @ scaled_spline_w.T

with degree-``spline_order`` Cox-de-Boor bases over a per-input-feature
knot grid.  Parameters keep the JAX package's layout, per layer
``{"base_w": (out, in), "spline_w": (out, in, n_coef), "spline_scaler":
(out, in), "grid": (in, n_knots)}``, so trees cross between the packages.
The knot grid is a buffer: it gets no gradient.

``curve2coeff`` is the SVD minimum-norm least-squares solve of
``jnp.linalg.lstsq`` (the same singular-value cutoff), on the tensor's own
device: the init's systems are underdetermined (grid_size + 1 rows, n_coef
columns) and ``kan_update_grid``'s may be rank-deficient, which
``torch.linalg.lstsq``'s CUDA backend (gels, full rank only) does not take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KANConfig:
    """The JAX package's defaults (the runner uses KAN([1, h, h, 1]))."""

    layers_hidden: tuple[int, ...] = (1, 256, 256, 1)
    grid_size: int = 5
    spline_order: int = 3
    scale_noise: float = 0.1
    scale_base: float = 1.0
    scale_spline: float = 1.0
    grid_eps: float = 0.02
    grid_range: tuple[float, float] = (-1.0, 1.0)
    standalone_spline_scaler: bool = True


def _make_grid(cfg: KANConfig, in_features: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Uniform knot grid extended by spline_order on both sides:
    (in_features, grid_size + 2 * order + 1), computed in float64 numpy and
    rounded once, as the JAX package does."""
    h = (cfg.grid_range[1] - cfg.grid_range[0]) / cfg.grid_size
    k = np.arange(-cfg.spline_order, cfg.grid_size + cfg.spline_order + 1)
    grid = np.tile(k * h + cfg.grid_range[0], (in_features, 1))
    return torch.tensor(grid, dtype=torch.float32, device=device)


def b_splines(x: torch.Tensor, grid: torch.Tensor,
              spline_order: int) -> torch.Tensor:
    """Cox-de-Boor bases: (batch, in) -> (batch, in, grid_size + order).
    Degree-0 indicators on half-open intervals, refined ``spline_order``
    times."""
    x = x.unsqueeze(-1)
    g = grid.unsqueeze(0)
    bases = ((x >= g[..., :-1]) & (x < g[..., 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - g[..., :-(k + 1)]) / (g[..., k:-1] - g[..., :-(k + 1)])
        right = (g[..., k + 1:] - x) / (g[..., k + 1:] - g[..., 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def _lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched min-norm least squares, ``jnp.linalg.lstsq``'s algorithm:
    thin SVD, singular values below eps * max(m, n) * s_max (or zero)
    dropped, x = V diag(1/s) U^T b."""
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = u.transpose(-1, -2) @ b
    return vh.transpose(-1, -2) @ (s_inv.unsqueeze(-1) * utb)


def curve2coeff(x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor,
                spline_order: int) -> torch.Tensor:
    """Least-squares spline coefficients through (x, y) samples: x (batch,
    in), y (batch, in, out) -> (out, in, n_coef)."""
    a = b_splines(x, grid, spline_order).transpose(0, 1)  # (in, batch, c)
    b = y.transpose(0, 1)                                 # (in, batch, out)
    sol = _lstsq_min_norm(a, b)                           # (in, c, out)
    return sol.permute(2, 0, 1).contiguous()


def _kaiming_uniform(generator: torch.Generator, shape, fan_in: int,
                     a: float) -> torch.Tensor:
    gain = math.sqrt(2.0 / (1.0 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    t = torch.empty(shape, dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=generator)


def kan_linear_init(generator: torch.Generator, cfg: KANConfig,
                    in_features: int, out_features: int,
                    device: torch.device | str = "cpu") -> Params:
    """KANLinear.reset_parameters: kaiming-uniform base weight (a =
    sqrt(5) * scale_base), a spline weight interpolating small noise at the
    interior knots (curve2coeff, on ``device``), a kaiming-uniform
    standalone scaler.  Random numbers come from ``generator`` (CPU)."""
    grid = _make_grid(cfg, in_features, device)
    base_w = _kaiming_uniform(generator, (out_features, in_features),
                              in_features, math.sqrt(5.0) * cfg.scale_base)
    noise = torch.rand((cfg.grid_size + 1, in_features, out_features),
                       generator=generator, dtype=torch.float32) - 0.5
    noise = (noise * cfg.scale_noise / cfg.grid_size).to(device)
    interior = grid.T[cfg.spline_order:-cfg.spline_order]
    spline_w = curve2coeff(interior, noise, grid, cfg.spline_order)
    if not cfg.standalone_spline_scaler:
        spline_w = spline_w * cfg.scale_spline
    p: Params = {"base_w": base_w.to(device), "spline_w": spline_w,
                 "grid": grid}
    if cfg.standalone_spline_scaler:
        p["spline_scaler"] = _kaiming_uniform(
            generator, (out_features, in_features), in_features,
            math.sqrt(5.0) * cfg.scale_spline).to(device)
    return p


def _scaled_spline_weight(p: Params) -> torch.Tensor:
    """spline_w times the per-(out, in) scaler when there is one."""
    if "spline_scaler" in p:
        return p["spline_w"] * p["spline_scaler"].unsqueeze(-1)
    return p["spline_w"]


def kan_linear_apply(p: Params, cfg: KANConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """silu(x) @ base_w.T + flat_bases @ flat_spline_w.T in true f32."""
    x = x.to(torch.float32)
    grid = p["grid"].detach()
    base = torch.nn.functional.silu(x) @ p["base_w"].T
    bases = b_splines(x, grid, cfg.spline_order)
    sw = _scaled_spline_weight(p)
    spline = bases.reshape(x.shape[0], -1) @ sw.reshape(sw.shape[0], -1).T
    return base + spline


def kan_init(generator: torch.Generator, cfg: KANConfig,
             device: torch.device | str = "cpu") -> Params:
    dims = zip(cfg.layers_hidden[:-1], cfg.layers_hidden[1:])
    return {"layers": [kan_linear_init(generator, cfg, i, o, device)
                       for i, o in dims]}


def kan_apply(params: Params, cfg: KANConfig, x: torch.Tensor) -> torch.Tensor:
    for p in params["layers"]:
        x = kan_linear_apply(p, cfg, x)
    return x


# ---------------------------------------------------------------------------
# Grid update + regularisation
# ---------------------------------------------------------------------------

@torch.no_grad()
def kan_linear_update_grid(p: Params, cfg: KANConfig, x: torch.Tensor,
                           margin: float = 0.01) -> Params:
    """Data-adaptive re-gridding: blend the sorted-activation grid with a
    uniform one by ``grid_eps``, extend it by spline_order knots each side,
    and refit spline_w to the layer's current (unreduced) spline output."""
    x = x.to(torch.float32)
    batch = x.shape[0]
    bases = b_splines(x, p["grid"], cfg.spline_order)
    sw = _scaled_spline_weight(p)
    y = torch.einsum("bic,oic->bio", bases, sw)

    x_sorted = torch.sort(x, dim=0).values
    idx = [int(i * (batch - 1) / cfg.grid_size)
           for i in range(cfg.grid_size + 1)]
    grid_adaptive = x_sorted[idx].T                              # (in, g+1)
    uniform_step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / cfg.grid_size
    steps = torch.arange(cfg.grid_size + 1, dtype=torch.float32,
                         device=x.device)
    grid_uniform = (steps[None, :] * uniform_step[:, None]
                    + x_sorted[0][:, None] - margin)
    grid = cfg.grid_eps * grid_uniform + (1 - cfg.grid_eps) * grid_adaptive
    k = cfg.spline_order
    below = grid[:, :1] - uniform_step[:, None] * torch.arange(
        k, 0, -1, dtype=torch.float32, device=x.device)[None, :]
    above = grid[:, -1:] + uniform_step[:, None] * torch.arange(
        1, k + 1, dtype=torch.float32, device=x.device)[None, :]
    grid = torch.cat([below, grid, above], dim=1)
    new_p = dict(p)
    new_p["grid"] = grid
    new_p["spline_w"] = curve2coeff(x, y, grid, cfg.spline_order)
    return new_p


@torch.no_grad()
def kan_update_grid(params: Params, cfg: KANConfig,
                    x: torch.Tensor) -> Params:
    """Whole-network re-gridding: layer i is re-gridded from the activations
    that reach it, and ``x`` propagates through the UPDATED layer."""
    x = torch.as_tensor(x, dtype=torch.float32)
    new_layers = []
    for p in params["layers"]:
        p2 = kan_linear_update_grid(p, cfg, x)
        new_layers.append(p2)
        x = kan_linear_apply(p2, cfg, x)
    return {"layers": new_layers}


def kan_regularization_loss(params: Params,
                            regularize_activation: float = 1.0,
                            regularize_entropy: float = 1.0) -> torch.Tensor:
    """Mean-|spline weight| L1 proxy plus the entropy of the per-edge L1
    mass, summed over layers."""
    total = torch.zeros((), dtype=torch.float32)
    for p in params["layers"]:
        l1 = torch.mean(torch.abs(p["spline_w"]), dim=-1)
        act = torch.sum(l1)
        prob = l1 / (act + 1e-12)
        entropy = -torch.sum(prob * torch.log(prob + 1e-12))
        total = total.to(act.device) + (regularize_activation * act
                                        + regularize_entropy * entropy)
    return total
