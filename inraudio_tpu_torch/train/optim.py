"""Adam + ReduceLROnPlateau as explicit tensor state (port of
``inraudio_tpu/train/optim.py``).

Every state may carry a leading window axis: a window population trains
with one Adam step count, learning rate, plateau best and bad-step counter
per window, as the JAX package's ``vmap`` over ``TrainState`` gives it.
``torch.optim`` keeps one learning rate per parameter group and cannot
express that, so none of it is used here.

Adam matches torch.optim.Adam: bias-corrected moments, eps after the sqrt,
no weight decay.  The plateau scheduler matches ReduceLROnPlateau's
defaults (threshold 1e-4 in 'rel' mode, mode 'min', cooldown 0).  Nothing
here reads a tensor back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class PlateauConfig:
    factor: float = 0.8
    patience: int = 200
    min_lr: float = 1e-6
    threshold: float = 1e-4  # 'rel' mode, mode='min'


class AdamState(NamedTuple):
    step: torch.Tensor   # int32, () or (k,)
    mu: Any              # first-moment tree
    nu: Any              # second-moment tree
    lr: torch.Tensor     # float32, () or (k,)


class PlateauState(NamedTuple):
    best: torch.Tensor     # best loss seen, float32
    num_bad: torch.Tensor  # int32 steps since improvement


def _lead(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-window () or (k,) scalar shaped to broadcast against ``leaf``
    (which carries the same leading window axis)."""
    return x.reshape(x.shape + (1,) * (leaf.ndim - x.ndim))


def adam_init(params: Any, cfg: AdamConfig,
              windows: int | None = None) -> AdamState:
    """Zero moments; ``windows`` gives step and lr a leading (k,) axis."""
    leaf = tree_leaves(params)[0]
    shape = () if windows is None else (int(windows),)
    zeros = lambda: tree_map(torch.zeros_like, params)
    return AdamState(
        step=torch.zeros(shape, dtype=torch.int32, device=leaf.device),
        mu=zeros(), nu=zeros(),
        lr=torch.full(shape, cfg.lr, dtype=torch.float32, device=leaf.device))


def global_norm_sq(grads: Any, windows: bool = False) -> torch.Tensor:
    """Sum of squares over every leaf: one scalar, or one per window when
    the leaves carry a leading window axis."""
    parts = [torch.sum(torch.square(g).reshape(g.shape[0], -1), dim=1)
             if windows else torch.sum(torch.square(g))
             for g in tree_leaves(grads)]
    return torch.stack(parts).sum(dim=0)


def clip_by_global_norm(grads: Any, max_norm: float,
                        windows: bool = False) -> Any:
    """Scale the gradient tree so its global L2 norm is <= max_norm.  With
    ``windows`` every window has its own norm, as under the JAX package's
    vmap: clipping across the population would let one diverging window
    shrink every other window's step."""
    norm = torch.sqrt(global_norm_sq(grads, windows))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
    return tree_map(lambda g: g * _lead(scale, g), grads)


def adam_update(state: AdamState, grads: Any, params: Any,
                cfg: AdamConfig) -> tuple[Any, AdamState]:
    step = state.step + 1
    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.mu,
                  grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.nu,
                  grads)
    tf = step.to(torch.float32)
    c1 = 1 - cfg.b1 ** tf
    c2 = 1 - cfg.b2 ** tf
    new_params = tree_map(
        lambda p, m, v: p - _lead(state.lr, p) * (m / _lead(c1, p)) / (
            torch.sqrt(v / _lead(c2, p)) + cfg.eps),
        params, mu, nu)
    return new_params, AdamState(step=step, mu=mu, nu=nu, lr=state.lr)


def plateau_init(windows: int | None = None,
                 device: torch.device | str = "cpu") -> PlateauState:
    shape = () if windows is None else (int(windows),)
    return PlateauState(
        best=torch.full(shape, float("inf"), dtype=torch.float32,
                        device=device),
        num_bad=torch.zeros(shape, dtype=torch.int32, device=device))


def plateau_update(state: PlateauState, loss: torch.Tensor, lr: torch.Tensor,
                   cfg: PlateauConfig) -> tuple[PlateauState, torch.Tensor]:
    """One scheduler.step(loss), elementwise over windows: improvement
    resets the bad-step counter; ``patience`` consecutive non-improving
    steps multiply lr by ``factor`` (floored at min_lr) and reset it."""
    improved = loss < state.best * (1.0 - cfg.threshold)
    best = torch.where(improved, loss, state.best)
    num_bad = torch.where(improved, torch.zeros_like(state.num_bad),
                          state.num_bad + 1)
    reduce_now = num_bad > cfg.patience
    new_lr = torch.where(reduce_now,
                         torch.clamp(lr * cfg.factor, min=cfg.min_lr), lr)
    num_bad = torch.where(reduce_now, torch.zeros_like(num_bad), num_bad)
    return PlateauState(best=best, num_bad=num_bad), new_lr
