"""The shared-backbone modulated SirenWithSnakeTanh in plain float32
PyTorch, and its joint training as an auto-decoder: one backbone for every
window of a clip, and a modulation row a window.

The architecture is COIN++'s (Dupont et al., "COIN++: Neural Compression
Across Modalities", arXiv:2201.12904): a base network shared by every
datum, and per datum a shift added to the pre-activation of every hidden
unit of every layer but the head.  With ``film_scale`` each unit also gets
a gain, ``(1 + s) pre + m``; the shift comes after the layer's omega, so a
sine layer is sin(omega (x W + b) + m).  A window's modulation row holds,
layer by layer, its h shifts (then, with ``film_scale``, its h gains).

Training (the port's ``train.modulated.modulated_fit``, the codec's
encode): the loss is the mean squared error over every row of every
window; the backbone's gradient is the sum over all windows' rows, each
window's modulation gradient the sum over its own rows; one global-norm
clip over the modulations and the backbone together; Adam on both, the
modulations at ``mods_lr_mult`` times the backbone's rate; one
ReduceLROnPlateau stepped on the loss, which scales both rates; the best
snapshot holds the parameters that produced the best loss.

Departures from COIN++:

- The modulations are fitted jointly with the backbone from zero, by
  gradient descent on every window at once (an auto-decoder), not found by
  a few inner steps from a meta-learned base network.
- The base network is the reference runner's sine + snake stack
  (``siren_snake_tanh``: the same layers and initial distributions), not a
  SIREN of sine layers only.

Departures from the port:

- The sine is ``torch.sin`` and Snake is x + (1/a) sin^2(a x), as in
  ``siren_snake_tanh`` (the port takes the double-angle form).
- Adam is ``torch.optim.Adam``'s single-tensor update, as ``common.train``
  has it (the port's is the same formula with its divisions in another
  order).
- The random numbers come from one ``torch.rand`` call on the device.
- The windows are computed in blocks of ``block`` windows, in window order,
  so that the reference fits in memory at any population size: the
  backbone's gradient and the loss are summed block by block.  A window's
  forward, residual and modulation gradient are its own, whatever its
  block; only the order of the backbone's and the loss's sums depends on
  the blocks.
"""

from __future__ import annotations

import math

import torch

from .common import leaves, matmul, tree_like
from .siren_snake_tanh import init as backbone_init
from .siren_snake_tanh import layer_kinds


def mod_dim(cfg: dict) -> int:
    """A window's modulation floats: h shifts (and h gains with
    ``film_scale``) for every layer but the head."""
    return (cfg["hidden_features"] * (len(layer_kinds(cfg)) - 1)
            * (2 if cfg["film_scale"] else 1))


def init(cfg: dict, generator: torch.Generator, device: torch.device,
         windows: int) -> dict:
    """{"shared": the backbone, drawn in one call from ``generator`` (a
    generator on ``device``), "mods": (windows, mod_dim) zeros}: zero
    modulations leave the backbone's function as it is."""
    return {"shared": backbone_init(cfg, generator, device),
            "mods": torch.zeros((windows, mod_dim(cfg)), dtype=torch.float32,
                                device=device)}


def forward(shared: dict, mods: torch.Tensor, cfg: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """Shared coordinates (n, in) and (k, mod_dim) modulations -> (k, n,
    out) in float32 (``tf32``: every product's operands rounded to TF32,
    the control)."""
    kinds = layer_kinds(cfg)
    h = cfg["hidden_features"]
    per = 2 * h if cfg["film_scale"] else h
    for i, (kind, p) in enumerate(zip(kinds, shared["layers"])):
        # one product over every window's rows: (k n, in) @ (in, out)
        rows = x.reshape(-1, x.shape[-1])
        pre = (matmul(rows, p["w"], tf32) + p["b"]).reshape(
            *x.shape[:-1], -1)
        if kind == "sine_first":
            pre = cfg["first_omega_0"] * pre
        elif kind == "sine":
            pre = cfg["hidden_omega_0"] * pre
        if i < len(kinds) - 1:
            shift = mods[:, i * per:i * per + h].unsqueeze(1)
            if cfg["film_scale"]:
                gain = 1.0 + mods[:, i * per + h:i * per + 2 * h]
                pre = gain.unsqueeze(1) * pre
            # layer 0's (n, h) is the grid's: the shift broadcasts it to
            # every window's (k, n, h)
            pre = pre + shift
        if kind in ("sine_first", "sine"):
            x = torch.sin(pre)
        elif kind == "linear_snake":
            a = p["snake_a"]
            x = pre + (1.0 / a) * torch.square(torch.sin(a * pre))
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:
            x = pre
    return x


def loss_and_grads(shared: dict, mods: torch.Tensor, cfg: dict,
                   coords: torch.Tensor, targets: torch.Tensor, block: int,
                   tf32: bool = False
                   ) -> tuple[float, float, dict[str, torch.Tensor],
                              torch.Tensor]:
    """The mean squared error over every row of every window of ``targets``
    (k, n, out), and its gradient: (loss, the loss's rounding size, the
    backbone's gradient by leaf name, the modulations' (k, mod_dim)), over
    blocks of ``block`` windows in window order.

    The rounding size is the norm of the rows' terms over their count,
    sqrt(sum r^4) / (k n): the size of a sum of the rows' rounding errors,
    each a like share of its row's term and of random sign.  A loss gap
    over it reads alike at any number of rows (the gap itself shrinks as
    one over the root of the rows)."""
    named = leaves(shared)
    live = {n: t.detach().clone().requires_grad_(True) for n, t in named}
    tree = tree_like(shared, live)
    grads = {n: torch.zeros_like(t) for n, t in named}
    mod_grads = torch.zeros_like(mods)
    count = targets.numel()
    total = torch.zeros((), dtype=torch.float32, device=targets.device)
    fourth = torch.zeros((), dtype=torch.float64, device=targets.device)
    with torch.enable_grad():
        for s in range(0, targets.shape[0], block):
            m = mods[s:s + block].detach().clone().requires_grad_(True)
            pred = forward(tree, m, cfg, coords, tf32)
            sq = torch.square(pred - targets[s:s + block])
            part = torch.sum(sq) / count
            got = torch.autograd.grad(part, [live[n] for n, _ in named] + [m])
            for (n, _), g in zip(named, got):
                grads[n] += g
            mod_grads[s:s + block] = got[-1]
            total += part.detach()
            fourth += torch.sum(torch.square(sq.detach().double()))
    return float(total), math.sqrt(float(fourth)) / count, grads, mod_grads


def train(init_tree: dict, coords: torch.Tensor, targets: torch.Tensor,
          cfg: dict, steps: int, block: int, tf32: bool = False) -> dict:
    """``steps`` joint steps from ``init_tree`` ({"shared", "mods"}) on
    ``targets`` (k, n, out) over the shared ``coords`` (n, in), ``block``
    windows at a time.

    Returns the loss of each step and its rounding size (``loss_scale``,
    as ``loss_and_grads`` gives it), and after the last step the backbone
    (``shared``, by leaf name) and the modulations (``mods``), their best
    snapshots (``best_shared``, ``best_mods``) and the backbone's learning
    rate."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    shared = {n: t.detach().clone() for n, t in leaves(init_tree["shared"])}
    mods = init_tree["mods"].detach().clone()
    params = {**shared, "mods": mods}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    best = {n: t.clone() for n, t in params.items()}
    mult = {n: cfg["mods_lr_mult"] if n == "mods" else 1.0 for n in params}
    lr = float(cfg["learning_rate"])
    clip = float(cfg["grad_clip_norm"])
    best_loss = plateau_best = math.inf
    bad = 0
    losses: list[float] = []
    scales: list[float] = []
    for t in range(1, steps + 1):
        loss, loss_scale, grads, mod_grads = loss_and_grads(
            tree_like(init_tree["shared"], params), params["mods"], cfg,
            coords, targets, block, tf32)
        grads["mods"] = mod_grads
        losses.append(loss)
        scales.append(loss_scale)
        if loss < best_loss:
            best_loss = loss
            best = {n: p.clone() for n, p in params.items()}
        if clip > 0:
            norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                  for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-20), max=1.0)
            grads = {n: g * scale for n, g in grads.items()}
        # torch.optim.Adam's single-tensor update, two parameter groups
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        for n, g in grads.items():
            m[n] = m[n] * b1 + g * (1 - b1)
            v[n] = v[n] * b2 + g * g * (1 - b2)
            denom = torch.sqrt(v[n]) / math.sqrt(c2) + eps
            params[n] = params[n] - (lr * mult[n] / c1) * m[n] / denom
        # ReduceLROnPlateau, threshold 1e-4 in 'rel' mode, cooldown 0
        if loss < plateau_best * (1 - 1e-4):
            plateau_best, bad = loss, 0
        else:
            bad += 1
        if bad > cfg["plateau_patience"]:
            lr = max(lr * cfg["plateau_factor"], cfg["min_learning_rate"])
            bad = 0
    split = lambda tree: ({n: t for n, t in tree.items() if n != "mods"},  # noqa
                          tree["mods"])
    shared, mods = split(params)
    best_shared, best_mods = split(best)
    return {"loss": losses, "loss_scale": scales, "shared": shared, "mods": mods,
            "best_shared": best_shared, "best_mods": best_mods, "lr": lr}
