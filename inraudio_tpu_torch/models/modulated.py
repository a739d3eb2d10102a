"""Shared-backbone modulated SIREN (port of
``inraudio_tpu/models/modulated.py``).

One SirenSnakeTanh backbone is shared by every window; each window stores
only a modulation vector ``m``: an additive pre-activation shift per hidden
unit of every layer but the output head (FiLM shift), and with
``film_scale`` a per-unit gain ``1 + s`` as well.  Per-window storage is
``mod_dim`` floats instead of a whole parameter set.

The JAX package computes this forward in plain XLA (no Pallas kernel), so
the port's is plain PyTorch: layer 0's ``omega0 * (x W + b)`` in exact fp32
and the hidden products in true fp32 (the package turns TF32 off when it is
imported).  A (k, mod_dim) modulation matrix evaluates k windows at once.
"""

from __future__ import annotations

import torch

from .activations import snake_apply
from .siren import (Params, SirenSnakeTanhConfig, linear_apply,
                    siren_snake_tanh_init)


def mod_dim(cfg: SirenSnakeTanhConfig, film_scale: bool = False) -> int:
    """Modulation vector length: one shift (plus one gain with
    ``film_scale``) per hidden unit of every layer except the head."""
    return (cfg.hidden_features * (len(cfg.layer_kinds) - 1)
            * (2 if film_scale else 1))


def modulated_init(generator: torch.Generator, cfg: SirenSnakeTanhConfig,
                   num_chunks: int, film_scale: bool = False,
                   device: torch.device | str = "cpu") -> Params:
    """-> {'shared': backbone params drawn from ``generator``, 'mods':
    (num_chunks, mod_dim) zeros}.  Zero modulations leave the backbone's
    function unchanged (gains enter as ``1 + s``)."""
    if getattr(cfg, "scaled_first", False):
        raise ValueError("modulated backbone does not support scaled_first")
    shared = siren_snake_tanh_init(generator, cfg, device)
    mods = torch.zeros((num_chunks, mod_dim(cfg, film_scale)),
                       dtype=torch.float32, device=device)
    return {"shared": shared, "mods": mods}


def modulated_apply(shared: Params, cfg: SirenSnakeTanhConfig,
                    coords: torch.Tensor, mod: torch.Tensor,
                    film_scale: bool = False) -> torch.Tensor:
    """The SirenSnakeTanh stack over ``coords`` (n, d) with ``mod``'s
    per-layer slice added to each non-final pre-activation (``s * pre + m``
    with ``film_scale``).  ``mod`` (mod_dim,) gives (n, out); a (k, mod_dim)
    matrix gives (k, n, out), one window per row, on the one backbone."""
    kinds = cfg.layer_kinds
    h = cfg.hidden_features
    per = 2 * h if film_scale else h
    x = coords.to(torch.float32)
    for i, (kind, p) in enumerate(zip(kinds, shared["layers"])):
        last = i == len(kinds) - 1
        if not last:
            # (..., h) -> (..., 1, h): one row per window, broadcast over n
            m = mod[..., i * per:i * per + h].unsqueeze(-2)
            s = ((1.0 + mod[..., i * per + h:i * per + 2 * h]).unsqueeze(-2)
                 if film_scale else None)

        def filmed(pre):
            return pre + m if s is None else s * pre + m

        pre = linear_apply(p, x)
        if kind == "sine_first":
            x = torch.sin(filmed(cfg.first_omega_0 * pre))
        elif kind == "sine":
            pre = cfg.hidden_omega_0 * pre
            x = torch.sin(pre if last else filmed(pre))
        elif kind == "linear_snake":
            x = snake_apply(p["snake_a"], filmed(pre))
        elif kind == "linear_tanh":
            x = torch.tanh(filmed(pre))
        elif kind == "linear_last":
            x = pre
        else:  # pragma: no cover
            raise ValueError(kind)
    return x
