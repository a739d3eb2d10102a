"""Training step and state (port of ``inraudio_tpu/train/loop.py``, without
``fit``).

``TrainState`` keeps the JAX package's fields.  For a window population
every leaf carries a leading window axis k and every scalar is a (k,)
tensor: each window has its own Adam step, learning rate, plateau state,
best snapshot and best loss, as under the JAX package's ``vmap``.

Two steps:
- ``make_train_step``: autograd of the model's apply, per-window MSE, so the
  gradient of the summed loss is each window's own; clip, Adam, plateau
  and best per window.  With a fused model its backward is kernel C.
- the whole-step kernel D (``ops.siren_step``), wired for a population by
  ``make_vmapped_fused_step`` when ``fused_step_plan`` admits the model.

Best-params semantics as the JAX package: ``track_best=True`` snapshots the
parameters that produced the best loss; False keeps the initial ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models import INRModel
from ..models.siren import params_from_jax, params_to_numpy
from ..tree import tree_leaves, tree_map, tree_unflatten
from .losses import mse
from .optim import (AdamConfig, AdamState, PlateauConfig, PlateauState,
                    adam_init, adam_update, clip_by_global_norm,
                    plateau_init, plateau_update)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's knobs that the ported steps read, with its names
    and defaults.  Ported so far: loss_mode 'mse' with alpha 0; the other
    losses, the KAN grid refresh and the precision schedule belong to
    ``fit``, which is not ported yet."""

    total_steps: int = 20000
    learning_rate: float = 1e-3
    min_learning_rate: float = 1e-6
    loss_mode: str = "mse"
    alpha: float = 0.0
    track_best: bool = True
    plateau_factor: float = 0.8
    plateau_patience: int = 200
    grad_clip_norm: float = 0.0
    # steps per round: the fit reads nothing back from the device inside a
    # round (the JAX package's lax.scan length)
    scan_chunk: int = 500


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    plateau: PlateauState
    best_params: Any
    best_loss: torch.Tensor
    best_iter: torch.Tensor


def init_train_state(model: INRModel, generator: torch.Generator,
                     cfg: TrainConfig, device: torch.device | str = "cpu",
                     windows: int | None = None) -> TrainState:
    """Fresh state: ``model.init`` drawn from ``generator``; ``windows``
    stacks a population with per-window scalars."""
    params = model.init(generator, device, windows=windows)
    shape = () if windows is None else (int(windows),)
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params,
        opt=adam_init(params, AdamConfig(lr=cfg.learning_rate), windows),
        plateau=plateau_init(windows, dev),
        best_params=tree_map(torch.clone, params),
        best_loss=torch.full(shape, float("inf"), dtype=torch.float32,
                             device=dev),
        best_iter=torch.zeros(shape, dtype=torch.int32, device=dev))


def _check_loss(cfg: TrainConfig) -> None:
    if cfg.loss_mode != "mse" or cfg.alpha != 0.0:
        raise NotImplementedError(
            f"loss_mode={cfg.loss_mode!r} alpha={cfg.alpha} is not ported "
            "yet (mse with alpha 0 is)")


def make_train_step(model: INRModel, cfg: TrainConfig):
    """One full-batch step: (state, coords, targets) -> (state, (loss,
    lr)).  With stacked state (leading k) ``targets`` is (k, n, out) and
    every window's loss, clip, Adam, plateau and best are its own."""
    _check_loss(cfg)
    adam_cfg = AdamConfig(lr=cfg.learning_rate)
    plateau_cfg = PlateauConfig(factor=cfg.plateau_factor,
                                patience=cfg.plateau_patience,
                                min_lr=cfg.min_learning_rate)

    def loss_fn(params, coords, targets):
        pred = model.apply(params, coords)
        if pred.dim() == 3:  # per window
            return torch.mean(torch.square(pred - targets), dim=(1, 2))
        return mse(pred, targets)

    def train_step(state: TrainState, coords, targets):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
            losses = loss_fn(params, coords, targets)
            grads = torch.autograd.grad(losses.sum(), leaves)
        loss = losses.detach().to(torch.float32)
        grads = tree_unflatten(state.params, list(grads))
        windows = loss.dim() == 1
        if cfg.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, cfg.grad_clip_norm, windows)
        new_params, opt = adam_update(state.opt, grads, state.params,
                                      adam_cfg)
        plateau, new_lr = plateau_update(state.plateau, loss, opt.lr,
                                         plateau_cfg)
        opt = opt._replace(lr=new_lr)
        improved = loss < state.best_loss
        if cfg.track_best:
            best_params = tree_map(
                lambda b, p: torch.where(_col(improved, p), p, b),
                state.best_params, state.params)
        else:
            best_params = state.best_params
        new_state = TrainState(
            params=new_params, opt=opt, plateau=plateau,
            best_params=best_params,
            best_loss=torch.where(improved, loss, state.best_loss),
            best_iter=torch.where(improved, opt.step - 1, state.best_iter))
        return new_state, (loss, new_lr)

    return train_step


def _col(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (leaf.dim() - x.dim()))


def fused_step_plan(model: INRModel, cfg: TrainConfig,
                    n_rows: int) -> int | None:
    """Row tile of the whole-step kernel, or None when the fit cannot route
    through it (non-mse loss, a model without the fused step).  A fused
    model at a width the kernels do not take raises ``ValueError`` (it is
    not sent elsewhere silently)."""
    ctx = model.fused_step_ctx
    if ctx is None:
        return None
    from ..ops.siren_step import step_block_rows
    from ..ops.siren_train import check_kernel_width
    check_kernel_width(ctx["cfg"])
    if cfg.loss_mode != "mse" or cfg.alpha != 0.0:
        return None
    return step_block_rows(ctx["cfg"], n_rows)


def make_vmapped_fused_step(model: INRModel, cfg: TrainConfig,
                            coords: torch.Tensor):
    """Wire kernel D for a window population on one shared grid (a model
    that ``fused_step_plan`` admits).

    Returns ``(vstep, to_flat, from_flat, prep_targets)``:
    ``vstep(states, targets)`` the population step (coords bound),
    ``to_flat`` / ``from_flat`` stacked TrainState <-> FlatTrainState,
    ``prep_targets(t)`` (k, n, 1) targets -> the kernel's (k, n) tensor on
    the coords' device.  The kernel masks the ragged row tile itself, so
    nothing is padded.  The step's arithmetic is the model's
    ``fused_step_ctx["step"]``."""
    from ..ops.siren_step import (flat_state_from_train_state,
                                  make_fused_mse_train_step,
                                  train_state_from_flat)
    ctx = model.fused_step_ctx
    mcfg = ctx["cfg"]
    fstep = make_fused_mse_train_step(mcfg, cfg, coords.shape[0],
                                      approx_sin=ctx["approx_sin"],
                                      step_call=ctx["step"])

    def vstep(states, targets):
        return fstep(states, coords, targets)

    def prep_targets(targets) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(targets, np.float32))
        return t.reshape(t.shape[0], -1).to(coords.device).contiguous()

    return (vstep, lambda s: flat_state_from_train_state(s, mcfg),
            lambda s: train_state_from_flat(s, mcfg), prep_targets)


# ---------------------------------------------------------------------------
# Carrying a TrainState across the packages (numpy in between)
# ---------------------------------------------------------------------------

def train_state_from_jax(state, device: torch.device | str = "cpu"
                         ) -> TrainState:
    """A JAX ``TrainState`` whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, state)``; any object with the same fields)
    -> the port's TrainState on ``device``: params, moments, best params,
    step, lr, plateau state, best_loss and best_iter."""
    conv = lambda t: params_from_jax(t, device)
    return TrainState(
        params=conv(state.params),
        opt=AdamState(step=conv(state.opt.step), mu=conv(state.opt.mu),
                      nu=conv(state.opt.nu), lr=conv(state.opt.lr)),
        plateau=PlateauState(best=conv(state.plateau.best),
                             num_bad=conv(state.plateau.num_bad)),
        best_params=conv(state.best_params),
        best_loss=conv(state.best_loss), best_iter=conv(state.best_iter))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's TrainState -> the same structure of host numpy arrays
    (field for field what the JAX package's TrainState holds)."""
    return TrainState(
        params=params_to_numpy(state.params),
        opt=AdamState(*(params_to_numpy(x) for x in state.opt)),
        plateau=PlateauState(*(params_to_numpy(x) for x in state.plateau)),
        best_params=params_to_numpy(state.best_params),
        best_loss=params_to_numpy(state.best_loss),
        best_iter=params_to_numpy(state.best_iter))
