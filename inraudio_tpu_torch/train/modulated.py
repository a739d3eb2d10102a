"""Joint fit of a shared modulated-SIREN backbone and per-window
modulations (port of ``inraudio_tpu/train/modulated.py``).

Auto-decoder training: one forward over the window population gives every
window's squared error; autograd of the mean gives the backbone's gradient
(the mean over windows) and each modulation row's own in one backward.
Adam, ReduceLROnPlateau and an optional global-norm clip over the whole
trainable tree, and a best snapshot of the pre-update parameters, as the
JAX package's jitted scan carries them.  Steps run in rounds of
``scan_chunk``; nothing is read back from the device inside a round.

On a mesh of more than one rank the windows are split: each rank holds its
share of the modulations, their Adam moments and the targets, the backbone
is replicated, and one all-reduce a step sums the backbone's gradient, the
loss and the modulations' squared gradient norm, so every rank clips by the
global norm, steps its plateau on the global loss and takes the same
backbone step.  The modulated forward has no kernel in the JAX package
either; it is PyTorch ops on the device.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.modulated import modulated_apply, modulated_init
from ..models.siren import SirenSnakeTanhConfig
from ..parallel.mesh import Mesh, resolve_mesh
from ..tree import tree_leaves, tree_map, tree_unflatten
from ..utils.observability import counter, span
from .loop import TrainConfig
from .optim import (AdamConfig, PlateauConfig, adam_init, adam_update,
                    plateau_init, plateau_update)


class ModulatedFitResult(NamedTuple):
    shared: Any              # backbone params (best snapshot), on the device
    mods: torch.Tensor       # (k, mod_dim) modulations (best snapshot)
    loss_history: np.ndarray  # (steps,) mean window loss
    train_time_s: float


def modulated_fit(model_cfg: SirenSnakeTanhConfig, targets: np.ndarray,
                  coords: np.ndarray, cfg: TrainConfig | None = None,
                  generator: torch.Generator | None = None,
                  device: torch.device | str | None = None,
                  mesh: Mesh | None = None, film_scale: bool = False,
                  mods_lr_mult: float = 1.0, frozen_shared: Any = None,
                  frozen_mods: np.ndarray | None = None,
                  init_shared: Any = None) -> ModulatedFitResult:
    """Fit backbone + modulations to a (k, n, 1) window-target stack on
    ``device`` (default the card; pass "cpu" for the CPU), all windows on
    the one (n, d) grid ``coords``.  The backbone is drawn from
    ``generator`` (``torch.Generator().manual_seed(0)`` when None).

    ``mesh`` (``parallel.make_mesh(device)`` when None) splits the windows
    over its ranks; k must divide by its size.  Every rank returns the
    whole result.

    ``mods_lr_mult``: the modulations' learning rate as a multiple of the
    backbone's; the plateau steps the backbone's rate and the ratio holds.
    ``frozen_shared``: a trained backbone; only the modulations train.
    ``frozen_mods``: the dual, modulations fixed (e.g. at their dequantized
    values) and only the backbone trains; ``init_shared`` warm-starts it.

    Under a ``torch.profiler`` session the call is the span ``inr.modfit``
    (attrs ``steps``, ``windows``, ``rows``: the rows of a step over every
    window), holding ``inr.modfit.prologue``, each round's
    ``inr.modfit.round`` (``steps``) and ``inr.modfit.epilogue``; the two
    waits for the card are ``inr.modfit.sync``.  Each call adds its windows
    times its steps to the counter ``modfit.window_steps``
    (``utils.observability``)."""
    cfg = cfg or TrainConfig()
    if cfg.loss_mode != "mse" or cfg.alpha != 0.0:
        raise ValueError("modulated_fit supports loss_mode='mse', alpha=0")
    if frozen_shared is not None and mods_lr_mult != 1.0:
        raise ValueError("mods_lr_mult is meaningless with frozen_shared — "
                         "cfg.learning_rate IS the modulation rate")
    if frozen_mods is not None and frozen_shared is not None:
        raise ValueError("frozen_mods and frozen_shared together leave "
                         "nothing to train")
    if init_shared is not None and frozen_shared is not None:
        raise ValueError("init_shared is discarded under frozen_shared — "
                         "pass one or the other")
    if frozen_mods is not None and mods_lr_mult != 1.0:
        raise ValueError("mods_lr_mult is meaningless with frozen_mods")
    k = targets.shape[0]
    with span("inr.modfit", steps=cfg.total_steps, windows=k,
              rows=k * targets.shape[1]):
        with span("inr.modfit.prologue"):
            mesh = resolve_mesh(mesh, device)
            dev = mesh.device
            if k % mesh.size:
                raise ValueError(f"{k} chunks do not shard over {mesh.size} "
                                 "ranks — pad the population to a mesh-size "
                                 "multiple")
            kr = k // mesh.size
            own = slice(mesh.rank * kr, (mesh.rank + 1) * kr)
            generator = generator or torch.Generator().manual_seed(0)
            init = modulated_init(generator, model_cfg, kr, film_scale)

            def f32(tree):
                return tree_map(
                    lambda x: torch.as_tensor(x).to(dev, torch.float32), tree)

            params: dict[str, Any] = {}
            if frozen_shared is None:
                params["shared"] = f32(init_shared if init_shared is not None
                                       else init["shared"])
            if frozen_mods is None:
                params["mods"] = init["mods"].to(dev)
            shared_c = f32(frozen_shared) if frozen_shared is not None else None
            mods_c = (f32(frozen_mods)[own] if frozen_mods is not None
                      else None)
            coords_d = torch.as_tensor(np.asarray(coords, np.float32)).to(dev)
            t = torch.as_tensor(np.asarray(targets, np.float32)[own]).to(dev)
            count = float(k * t.shape[1] * t.shape[2])

            # one Adam state per trainable group; the plateau steps the first
            # group's rate (the backbone's, or the modulations' when it is
            # frozen)
            adam_cfg = AdamConfig(lr=cfg.learning_rate)
            groups = list(params)
            mult = {"shared": 1.0, "mods": mods_lr_mult}
            opt = {g: adam_init(params[g], AdamConfig(lr=cfg.learning_rate
                                                      * mult[g]))
                   for g in groups}
            plat_cfg = PlateauConfig(factor=cfg.plateau_factor,
                                     patience=cfg.plateau_patience,
                                     min_lr=cfg.min_learning_rate)
            plat = plateau_init(device=dev)
            best_loss = torch.tensor(float("inf"), device=dev)
            best = tree_map(torch.clone, params) if cfg.track_best else None
            sync = (torch.cuda.synchronize if dev.type == "cuda"
                    else (lambda: None))
            with span("inr.modfit.sync"):
                sync()

        def step(params, opt, plat, best_loss, best):
            leaves = [v.detach().requires_grad_(True)
                      for v in tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            with torch.enable_grad():
                out = modulated_apply(p.get("shared", shared_c), model_cfg,
                                      coords_d, p.get("mods", mods_c),
                                      film_scale=film_scale)
                # this rank's share of the mean over all k windows
                loss = torch.sum(torch.square(out - t)) / count
                grads = tree_unflatten(params, list(torch.autograd.grad(
                    loss, leaves)))
            mods_sq = (torch.sum(torch.square(grads["mods"]))
                       if "mods" in grads else torch.zeros((), device=dev))
            if mesh.size > 1:
                sh = tree_leaves(grads.get("shared", {}))
                buf = torch.cat([g.reshape(-1) for g in sh]
                                + [loss.detach().reshape(1),
                                   mods_sq.reshape(1)])
                mesh.all_reduce_(buf)
                parts = torch.split(buf, [g.numel() for g in sh] + [1, 1])
                if sh:
                    grads["shared"] = tree_unflatten(
                        grads["shared"],
                        [q.view_as(g) for q, g in zip(parts, sh)])
                loss, mods_sq = parts[-2].reshape(()), parts[-1].reshape(())
            loss = loss.detach()
            if best is not None:
                improved = loss < best_loss
                best_loss = torch.where(improved, loss, best_loss)
                best = tree_map(lambda b, cur: torch.where(improved, cur, b),
                                best, params)
            if cfg.grad_clip_norm > 0:
                # the JAX package's leaf order: mods, then the backbone
                norm_sq = mods_sq
                for g in tree_leaves(grads.get("shared", {})):
                    norm_sq = norm_sq + torch.sum(torch.square(g))
                scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(
                    torch.sqrt(norm_sq), min=1e-20), max=1.0)
                grads = tree_map(lambda g: g * scale, grads)
            new_params, new_opt = {}, {}
            for g in groups:
                new_params[g], new_opt[g] = adam_update(opt[g], grads[g],
                                                        params[g], adam_cfg)
            plat, lr = plateau_update(plat, loss, new_opt[groups[0]].lr,
                                      plat_cfg)
            new_opt = {g: new_opt[g]._replace(lr=lr * mult[g])
                       for g in groups}
            return new_params, new_opt, plat, best_loss, best, loss

        t0 = time.time()
        hists = []
        done = 0
        chunk = max(1, min(cfg.scan_chunk, cfg.total_steps))
        while done < cfg.total_steps:
            m = min(chunk, cfg.total_steps - done)
            with span("inr.modfit.round", steps=m):
                round_losses = []
                for _ in range(m):
                    params, opt, plat, best_loss, best, loss = step(
                        params, opt, plat, best_loss, best)
                    round_losses.append(loss)
                hists.append(torch.stack(round_losses))
            done += m
        with span("inr.modfit.epilogue"):
            # the card's queue drains in its own span: the epilogue's self
            # time is the host's
            with span("inr.modfit.sync"):
                sync()
            train_time = mesh.span(t0, time.time())
            final = best if best is not None else params
            hist = (torch.cat(hists).cpu().numpy() if hists
                    else np.zeros((0,), np.float32))
            shared = final["shared"] if "shared" in final else shared_c
            mods = (mesh.all_gather(final["mods"]) if "mods" in final
                    else f32(frozen_mods))
            # this rank's windows: the ranks of one process add up to the
            # population's window steps
            counter("modfit.window_steps").add(kr * cfg.total_steps)
        return ModulatedFitResult(shared=shared, mods=mods,
                                  loss_history=hist, train_time_s=train_time)
