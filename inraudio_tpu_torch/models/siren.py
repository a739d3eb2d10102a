"""SirenWithSnakeTanh, the production model (port of
``inraudio_tpu/models/siren.py``, SirenSnakeTanh part).

Parameters keep the JAX package's layout: ``{"layers": [{"w": (in, out),
"b": (out,), "snake_a": (out,)?}]}``.  Every leaf may carry a leading window
axis k (a stacked population); ``apply`` then evaluates all windows on the
one coordinate grid and returns (k, n, out).  The scaled-sine first layer
(``scaled_first``) is not ported yet: no payload header selects it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..tree import tree_map
from .activations import snake_apply, snake_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SirenSnakeTanhConfig:
    """Layer recipe of the production hybrid model; the same fields and
    defaults as the JAX package's config, so payload headers map 1:1."""

    in_features: int = 1
    hidden_features: int = 256
    out_features: int = 1
    num_sine: int = 2
    num_snake: int = 2
    num_tanh: int = 0
    first_linear: bool = False
    last_linear: bool = True
    first_omega_0: float = 22000.0
    hidden_omega_0: float = 30.0
    a_initial: float | None = 0.5  # None => Exponential(0.1) random init

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        kinds = ["linear_snake" if self.first_linear else "sine_first"]
        kinds += ["sine"] * self.num_sine
        kinds += ["linear_snake"] * self.num_snake
        kinds += ["linear_tanh"] * self.num_tanh
        kinds += ["linear_last" if self.last_linear else "sine"]
        return tuple(kinds)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=generator)


def siren_snake_tanh_init(generator: torch.Generator,
                          cfg: SirenSnakeTanhConfig,
                          device: torch.device | str = "cpu",
                          windows: int | None = None) -> Params:
    """SIREN-bounded init drawn from ``generator``.

    Bounds as in the reference: first sine layer W ~ U(-1/in, 1/in); sine
    layers U(-sqrt(6/in)/omega, +); snake and tanh layers torch's
    nn.Linear default U(-1/sqrt(in), +); the linear head the hidden sine
    bound.  Biases U(-1/sqrt(in), +).  ``windows`` stacks that many
    independent draws on a leading axis.  The numbers differ from the JAX
    package's for the same seed (different generators); only the
    distributions match.
    """
    lead = () if windows is None else (int(windows),)
    kinds = cfg.layer_kinds
    hidden_bound = math.sqrt(6.0 / cfg.hidden_features) / cfg.hidden_omega_0
    layers: list[Params] = []
    for i, kind in enumerate(kinds):
        in_f = cfg.in_features if i == 0 else cfg.hidden_features
        out_f = cfg.out_features if i == len(kinds) - 1 else cfg.hidden_features
        if kind == "sine_first":
            w_bound = 1.0 / in_f
        elif kind == "sine":
            w_bound = math.sqrt(6.0 / in_f) / cfg.hidden_omega_0
        elif kind in ("linear_snake", "linear_tanh"):
            w_bound = 1.0 / math.sqrt(in_f)
        elif kind == "linear_last":
            w_bound = hidden_bound
        else:  # pragma: no cover
            raise ValueError(kind)
        p = {"w": _uniform((*lead, in_f, out_f), w_bound, generator),
             "b": _uniform((*lead, out_f), 1.0 / math.sqrt(in_f), generator)}
        if kind == "linear_snake":
            p["snake_a"] = snake_init(out_f, cfg.a_initial, generator,
                                      leading=lead)
        layers.append({k: v.to(device) for k, v in p.items()})
    return {"layers": layers}


def _row(v: torch.Tensor) -> torch.Tensor:
    """(..., out) per-unit vector -> (..., 1, out), broadcastable against a
    (..., n, out) activation with or without a window axis."""
    return v.unsqueeze(-2)


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b in true float32."""
    return torch.matmul(x, p["w"]) + _row(p["b"])


def siren_snake_tanh_apply(params: Params, cfg: SirenSnakeTanhConfig,
                           coords: torch.Tensor) -> torch.Tensor:
    """Exact-semantics forward: true f32 matmuls and ``torch.sin``.

    ``coords`` (n, d); unstacked params give (n, out), stacked (k, ...)
    params give (k, n, out)."""
    x = coords.to(torch.float32)
    for kind, p in zip(cfg.layer_kinds, params["layers"]):
        pre = linear_apply(p, x)
        if kind == "sine_first":
            x = torch.sin(cfg.first_omega_0 * pre)
        elif kind == "sine":
            x = torch.sin(cfg.hidden_omega_0 * pre)
        elif kind == "linear_snake":
            x = snake_apply(_row(p["snake_a"]), pre)
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:  # linear_last
            x = pre
    return x


def tensor_from_numpy(a: np.ndarray, bfloat16_bits: bool = False
                      ) -> torch.Tensor:
    """A CPU tensor copy of ``a``.  bfloat16 travels as its bit pattern:
    an ml_dtypes bfloat16 array (what JAX arrays convert to), or a uint16
    array when ``bfloat16_bits``, becomes a torch.bfloat16 tensor."""
    a = np.asarray(a)
    if bfloat16_bits or a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """A parameter tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``, dtypes kept."""
    return tree_map(lambda a: tensor_from_numpy(a).to(device), tree)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree: Any) -> Any:
    """The port's parameter tree -> the same tree of host numpy arrays.
    bfloat16 leaves widen to float32 (exact); numpy has no bfloat16."""
    return tree_map(_leaf_to_numpy, tree)
