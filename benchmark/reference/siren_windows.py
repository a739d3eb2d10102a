"""A population of SirenWithSnakeTanh models, one a window of a clip, in
plain float32 PyTorch, and the codec's training of it: each window's own
MSE over its rows, its own global-norm clip, Adam, ReduceLROnPlateau and
best snapshot, all windows at once on one shared coordinate grid.

Each window is ``siren_snake_tanh``'s model (the same layers, the same
initial distributions); the parameter tree stacks the windows on a leading
axis: per layer ``w`` (k, in, out), ``b`` (k, out), ``snake_a`` (k, out).

Departures from the codec (the JAX package's ``bench_multi`` and the port's
``multi_inr_fit``): the sine is ``torch.sin`` (the fused path takes a
polynomial); Adam is ``torch.optim.Adam``'s single-tensor update, as in
``common.train``; the random numbers come from one ``torch.rand`` call on
the device.  The windows are trained in blocks of windows, so that the
reference fits in memory at any population size; a window's arithmetic
does not depend on its block.
"""

from __future__ import annotations

import math

import torch

from .common import leaves, matmul, tree_like
from .siren_snake_tanh import _bounds, layer_kinds


def init(cfg: dict, generator: torch.Generator, device: torch.device,
         windows: int) -> dict:
    """``windows`` models' initial parameters, drawn in one call from
    ``generator`` (a generator on ``device``)."""
    shapes = _bounds(cfg)
    total = sum(din * dout + dout for din, dout, _, _ in shapes)
    u = torch.rand((windows, total), generator=generator, device=device,
                   dtype=torch.float32) * 2.0 - 1.0
    layers, off = [], 0
    for din, dout, bound, kind in shapes:
        w = u[:, off:off + din * dout].reshape(windows, din, dout) * bound
        off += din * dout
        b = u[:, off:off + dout] * (1.0 / math.sqrt(din))
        off += dout
        layer = {"w": w.contiguous(), "b": b.contiguous()}
        if kind == "linear_snake":
            layer["snake_a"] = torch.full((windows, dout),
                                          float(cfg["a_initial"]),
                                          dtype=torch.float32, device=device)
        layers.append(layer)
    return {"layers": layers}


def forward(params: dict, cfg: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """Shared coordinates (n, in) -> (k, n, out) in float32 (``tf32``: every
    product's operands rounded to TF32, the control)."""
    k = params["layers"][0]["w"].shape[0]
    x = x.expand(k, *x.shape)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        pre = matmul(x, p["w"], tf32) + p["b"].unsqueeze(1)
        if kind == "sine_first":
            x = torch.sin(cfg["first_omega_0"] * pre)
        elif kind == "sine":
            x = torch.sin(cfg["hidden_omega_0"] * pre)
        elif kind == "linear_snake":
            a = p["snake_a"].unsqueeze(1)
            x = pre + (1.0 / a) * torch.square(torch.sin(a * pre))
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:
            x = pre
    return x


def _lead(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A per-window (k,) value shaped to broadcast against a (k, ...) leaf."""
    return v.reshape(v.shape + (1,) * (t.dim() - 1))


def _loss_and_grads(params0: dict, params: dict[str, torch.Tensor],
                    cfg: dict, coords: torch.Tensor, targets: torch.Tensor,
                    tf32: bool):
    """Each window's MSE over its rows (k,) and its gradient."""
    live = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    with torch.enable_grad():
        pred = forward(tree_like(params0, live), cfg, coords, tf32)
        losses = torch.sum(torch.square(pred - targets), dim=(1, 2)) \
            / targets.shape[1]
        grads = torch.autograd.grad(losses.sum(), list(live.values()))
    return losses.detach(), dict(zip(live, grads))


def _train_block(params0: dict, coords: torch.Tensor, targets: torch.Tensor,
                 cfg: dict, steps: int, tf32: bool) -> dict:
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = {n: t.detach().clone() for n, t in leaves(params0)}
    k = targets.shape[0]
    dev = targets.device
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    best = {n: t.clone() for n, t in params.items()}
    lr = torch.full((k,), float(cfg["learning_rate"]), device=dev)
    best_loss = torch.full((k,), math.inf, device=dev)
    plateau_best = torch.full((k,), math.inf, device=dev)
    bad = torch.zeros((k,), dtype=torch.int64, device=dev)
    clip = float(cfg["grad_clip_norm"])
    losses = []
    for t in range(1, steps + 1):
        loss, grads = _loss_and_grads(params0, params, cfg, coords, targets,
                                      tf32)
        if clip > 0:
            sq = sum(torch.sum(torch.square(g).reshape(k, -1), dim=1)
                     for g in grads.values())
            scale = torch.clamp(clip / torch.clamp(torch.sqrt(sq), min=1e-20),
                                max=1.0)
            grads = {n: g * _lead(scale, g) for n, g in grads.items()}
        if t == 1:
            first_grad = grads
        losses.append(loss)
        improved = loss < best_loss
        best = {n: torch.where(_lead(improved, p), p, best[n])
                for n, p in params.items()}
        best_loss = torch.where(improved, loss, best_loss)
        # torch.optim.Adam's single-tensor update, each window at its lr
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        for n, g in grads.items():
            m[n] = m[n] * b1 + g * (1 - b1)
            v[n] = v[n] * b2 + g * g * (1 - b2)
            denom = torch.sqrt(v[n]) / math.sqrt(c2) + eps
            params[n] = params[n] - _lead(lr / c1, g) * m[n] / denom
        # ReduceLROnPlateau per window: threshold 1e-4 'rel', cooldown 0
        better = loss < plateau_best * (1 - 1e-4)
        plateau_best = torch.where(better, loss, plateau_best)
        bad = torch.where(better, torch.zeros_like(bad), bad + 1)
        cut = bad > cfg["plateau_patience"]
        lr = torch.where(cut, torch.clamp(lr * cfg["plateau_factor"],
                                          min=cfg["min_learning_rate"]), lr)
        bad = torch.where(cut, torch.zeros_like(bad), bad)
    return {"loss": torch.stack(losses), "grad": first_grad,
            "params": params, "best_params": best, "lr": lr}


def train(params0: dict, coords: torch.Tensor, targets: torch.Tensor,
          cfg: dict, steps: int, block: int, tf32: bool = False) -> dict:
    """``steps`` steps of every window from ``params0`` on ``targets`` (k,
    n, 1) over the shared ``coords`` (n, 1), ``block`` windows at a time.

    Returns each step's loss of each window (steps, k), the first step's
    gradient as Adam got it (after the clip), and after the last step the
    parameters, the best snapshot and the learning rate, by leaf name."""
    k = targets.shape[0]
    parts = []
    for s in range(0, k, block):
        part = {"layers": [{key: t[s:s + block] for key, t in layer.items()}
                           for layer in params0["layers"]]}
        parts.append(_train_block(part, coords, targets[s:s + block], cfg,
                                  steps, tf32))
    cat = lambda key: {n: torch.cat([p[key][n] for p in parts])  # noqa
                       for n in parts[0][key]}
    return {"loss": torch.cat([p["loss"] for p in parts], dim=1),
            "grad": cat("grad"), "params": cat("params"),
            "best_params": cat("best_params"),
            "lr": torch.cat([p["lr"] for p in parts])}
