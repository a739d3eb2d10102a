"""What the references share: the float32 matmul (or its TF32 control), the
parameter tree's leaves, and the reference runner's loop (full-batch Adam,
ReduceLROnPlateau stepped on every loss, the best snapshot).

Departures from the reference runner (senyuanfan/inr-for-audio run.py):

- The best snapshot holds the parameters that produced the best loss.  The
  runner's ``best_model = model`` is an alias, so its "best" model is the
  final one; the port, as the JAX package, keeps a true snapshot, and that
  is what is compared.
- The loss and gradients are summed over blocks of rows, so that the
  reference fits in memory at any clip length; each block's squared error
  is divided by the whole clip's rows, so the sum is the runner's MSE.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def set_float32_matmul() -> None:
    """True float32 products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    still stored as float32: what a TF32 tensor core reads."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 in every product, the
    backward's too, and float32 accumulation."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """float32 a @ b, or the TF32 control's."""
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def leaves(tree: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) for every leaf of a ``{"layers": [{key: tensor}]}``
    tree, in layer order and key order."""
    return [(f"layers.{i}.{k}", layer[k])
            for i, layer in enumerate(tree["layers"]) for k in sorted(layer)]


def tree_like(tree: dict, values: dict[str, torch.Tensor]) -> dict:
    return {"layers": [{k: values[f"layers.{i}.{k}"] for k in layer}
                       for i, layer in enumerate(tree["layers"])]}


def loss_and_grads(forward: Callable, params: dict, coords: torch.Tensor,
                   targets: torch.Tensor, block: int, frozen: set[str],
                   scale: bool = False):
    """The MSE over every row of (coords, targets) and its gradient, summed
    over blocks of ``block`` rows; the leaves named in ``frozen`` (buffers)
    get a zero gradient.  ``scale`` also returns the gradient's scale: the
    same sum with each row's residual given a sign of its own,
    (2 / n) sum s_i (p_i - t_i) dp_i/dtheta with s_i = +-1 from a fixed
    draw.  Its norm is about sqrt(sum_i |term_i|^2), the size of a sum of
    rounding errors that each row's term carries, which the terms' own
    cancellation does not shrink."""
    named = leaves(params)
    live = {n: t.detach().clone().requires_grad_(n not in frozen)
            for n, t in named}
    tree = tree_like(params, live)
    trainable = [n for n, _ in named if n not in frozen]
    grads = {n: torch.zeros_like(t) for n, t in named}
    scales = {n: torch.zeros_like(t) for n, t in named}
    n_rows = coords.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=coords.device)
    if scale:
        gen = torch.Generator(device=coords.device)
        gen.manual_seed(0)
        signs = (torch.randint(0, 2, (n_rows, 1), generator=gen,
                               device=coords.device) * 2 - 1).float()
    with torch.enable_grad():
        for s in range(0, n_rows, block):
            pred = forward(tree, coords[s:s + block])
            res = pred - targets[s:s + block]
            part = torch.sum(torch.square(res)) / n_rows
            inputs = [live[n] for n in trainable]
            got = torch.autograd.grad(part, inputs, retain_graph=scale)
            for n, g in zip(trainable, got):
                grads[n] += g
            if scale:
                wide = 2 * torch.sum(res.detach() * signs[s:s + block]
                                     * pred) / n_rows
                for n, g in zip(trainable, torch.autograd.grad(wide, inputs)):
                    scales[n] += g
            total += part.detach()
    if scale:
        return float(total), grads, scales
    return float(total), grads


def train(forward: Callable, params0: dict, coords: torch.Tensor,
          targets: torch.Tensor, hp: dict, steps: int, block: int,
          frozen: set[str] = frozenset()) -> dict:
    """``steps`` steps of the reference runner from ``params0``:
    ``torch.optim.Adam`` (lr ``hp["learning_rate"]``, betas (0.9, 0.999),
    eps 1e-8) and ``ReduceLROnPlateau(mode="min", factor, patience,
    min_lr)`` stepped on every loss, and the best snapshot.

    Returns the loss of each step, the first step's gradient and its scale
    (``loss_and_grads``), and after the last step the parameters, the best
    snapshot and the learning rate."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = {n: t.detach().clone() for n, t in leaves(params0)}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    best = {n: t.clone() for n, t in params.items()}
    lr = float(hp["learning_rate"])
    best_loss = plateau_best = math.inf
    bad = 0
    losses: list[float] = []
    for t in range(1, steps + 1):
        if t == 1:
            loss, grads, grad_scale = loss_and_grads(
                forward, tree_like(params0, params), coords, targets, block,
                frozen, scale=True)
            first_grad = grads
        else:
            loss, grads = loss_and_grads(forward, tree_like(params0, params),
                                         coords, targets, block, frozen)
        losses.append(loss)
        if loss < best_loss:
            best_loss = loss
            best = {n: p.clone() for n, p in params.items()}
        # torch.optim.Adam's single-tensor update
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        for n, g in grads.items():
            m[n] = m[n] * b1 + g * (1 - b1)
            v[n] = v[n] * b2 + g * g * (1 - b2)
            denom = torch.sqrt(v[n]) / math.sqrt(c2) + eps
            params[n] = params[n] - (lr / c1) * m[n] / denom
        # ReduceLROnPlateau, threshold 1e-4 in 'rel' mode, cooldown 0
        if loss < plateau_best * (1 - 1e-4):
            plateau_best, bad = loss, 0
        else:
            bad += 1
        if bad > hp["plateau_patience"]:
            lr = max(lr * hp["plateau_factor"], hp["min_learning_rate"])
            bad = 0
    return {"loss": losses, "grad": first_grad, "grad_scale": grad_scale,
            "params": params,
            "best_params": best, "lr": lr}


def forward_blocks(forward: Callable, params: dict, coords: torch.Tensor,
                   block: int) -> torch.Tensor:
    """The model over every row, in blocks, without gradients."""
    with torch.no_grad():
        return torch.cat([forward(params, coords[s:s + block])
                          for s in range(0, coords.shape[0], block)])
