"""The SIREN family (port of ``inraudio_tpu/models/siren.py``): the
layers (``linear_init``, ``sine_layer_*``, ``scaled_sine_layer_*``), the
classic SIREN (``SirenConfig``, ``siren_init`` / ``siren_apply`` /
``siren_activations``) and SirenWithSnakeTanh, the production model, with
its scaled-sine first layer (``scaled_first``).

Parameters keep the JAX package's layout: ``{"layers": [{"w": (in, out),
"b": (out,), "snake_a": (out,)?, "omega_scale": (out,)?}]}``.  Every leaf
may carry a leading window axis k (a stacked population); ``apply`` then
evaluates all windows on the one coordinate grid and returns (k, n, out).
Products are true float32 ``torch.matmul`` (the package turns TF32 off);
the first layer's ``omega0 * (x W + b)`` is an exact float32 product.
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
    # first layer a scaled sine layer: a fixed per-unit frequency
    # omega0 * linspace(0, 1, h) / h (``scaled_sine_layer_init``)
    scaled_first: bool = False
    last_linear: bool = True
    first_omega_0: float = 22000.0
    hidden_omega_0: float = 30.0
    a_initial: float | None = 0.5  # None => Exponential(0.1) random init

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        if self.first_linear:
            first = "linear_snake"
        elif self.scaled_first:
            first = "scaled_sine_first"
        else:
            first = "sine_first"
        kinds = [first]
        kinds += ["sine"] * self.num_sine
        kinds += ["linear_snake"] * self.num_snake
        kinds += ["linear_tanh"] * self.num_tanh
        kinds += ["linear_last" if self.last_linear else "sine"]
        return tuple(kinds)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=generator)


def _lead(windows: int | None) -> tuple[int, ...]:
    return () if windows is None else (int(windows),)


def linear_init(generator: torch.Generator, in_features: int,
                out_features: int, w_bound: float,
                b_bound: float | None = None,
                device: torch.device | str = "cpu",
                windows: int | None = None) -> Params:
    """W ~ U(-w_bound, w_bound) (in, out), b ~ U(-b_bound, b_bound) with
    torch ``nn.Linear``'s default bound 1/sqrt(in) when ``b_bound`` is
    None; ``windows`` stacks that many draws on a leading axis."""
    lead = _lead(windows)
    if b_bound is None:
        b_bound = 1.0 / math.sqrt(in_features)
    w = _uniform((*lead, in_features, out_features), w_bound, generator)
    b = _uniform((*lead, out_features), b_bound, generator)
    return {"w": w.to(device), "b": b.to(device)}


def _sine_bound(in_features: int, is_first: bool, omega0: float) -> float:
    return (1.0 / in_features if is_first
            else math.sqrt(6.0 / in_features) / omega0)


def sine_layer_init(generator: torch.Generator, in_features: int,
                    out_features: int, is_first: bool = False,
                    omega0: float = 30.0, device: torch.device | str = "cpu",
                    windows: int | None = None) -> Params:
    """SIREN init: the first layer W ~ U(-1/in, 1/in), a hidden one
    U(-sqrt(6/in)/omega0, +); the bias keeps nn.Linear's default."""
    return linear_init(generator, in_features, out_features,
                       _sine_bound(in_features, is_first, omega0),
                       device=device, windows=windows)


def scaled_sine_layer_init(generator: torch.Generator, in_features: int,
                           out_features: int, is_first: bool = False,
                           omega0: float = 30.0,
                           device: torch.device | str = "cpu",
                           windows: int | None = None) -> Params:
    """A sine layer with a fixed per-unit frequency ``omega_scale``: the
    first layer's unit k takes omega0 * linspace(0, 1, out)[k] / out, a
    hidden one omega0.  ``omega_scale`` is a constant buffer: it gets no
    gradient."""
    p = sine_layer_init(generator, in_features, out_features, is_first,
                        omega0, device, windows)
    p["omega_scale"] = _omega_scale(out_features, omega0, is_first,
                                    _lead(windows)).to(device)
    return p


def _omega_scale(out_features: int, omega0: float, is_first: bool,
                 lead: tuple[int, ...]) -> torch.Tensor:
    """A scaled sine layer's per-unit frequencies: omega0 * linspace(0, 1,
    out) / out for the first layer, omega0 otherwise, in float32."""
    if is_first:
        scale = np.linspace(0.0, 1.0, out_features,
                            dtype=np.float32) / out_features
    else:
        scale = np.ones((out_features,), dtype=np.float32)
    return torch.from_numpy(scale * np.float32(omega0)).expand(
        *lead, out_features).contiguous()


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
        if kind in ("sine_first", "scaled_sine_first"):
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
        elif kind == "scaled_sine_first":
            p["omega_scale"] = _omega_scale(out_f, cfg.first_omega_0, True,
                                            lead)
        layers.append({k: v.to(device) for k, v in p.items()})
    return {"layers": layers}


def _row(v: torch.Tensor) -> torch.Tensor:
    """(..., out) per-unit vector -> (..., 1, out), broadcastable against a
    (..., n, out) activation with or without a window axis."""
    return v.unsqueeze(-2)


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b in true float32."""
    return torch.matmul(x, p["w"]) + _row(p["b"])


def sine_layer_apply(p: Params, x: torch.Tensor,
                     omega0: float) -> torch.Tensor:
    """sin(omega0 (x W + b))."""
    return torch.sin(omega0 * linear_apply(p, x.to(torch.float32)))


def scaled_sine_layer_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """sin(omega_scale * (x W + b)), per unit; no gradient reaches
    ``omega_scale``."""
    pre = linear_apply(p, x.to(torch.float32))
    return torch.sin(_row(p["omega_scale"].detach()) * pre)


@dataclasses.dataclass(frozen=True)
class SirenConfig:
    """The classic SIREN: a first sine layer, ``hidden_layers`` hidden sine
    layers, a SIREN-bounded linear head (or a sine layer); the JAX
    package's fields and defaults."""

    in_features: int = 1
    hidden_features: int = 256
    hidden_layers: int = 3
    out_features: int = 1
    outermost_linear: bool = True
    first_omega_0: float = 30.0
    hidden_omega_0: float = 30.0


def siren_init(generator: torch.Generator, cfg: SirenConfig,
               device: torch.device | str = "cpu",
               windows: int | None = None) -> Params:
    """Drawn from ``generator``: the first sine layer, the hidden ones, and
    the head with the hidden sine bound (a linear layer, or a sine layer
    when not ``outermost_linear``)."""
    h = cfg.hidden_features
    layers = [sine_layer_init(generator, cfg.in_features, h, is_first=True,
                              omega0=cfg.first_omega_0, device=device,
                              windows=windows)]
    for _ in range(cfg.hidden_layers):
        layers.append(sine_layer_init(generator, h, h,
                                      omega0=cfg.hidden_omega_0,
                                      device=device, windows=windows))
    layers.append(linear_init(generator, h, cfg.out_features,
                              _sine_bound(h, False, cfg.hidden_omega_0),
                              device=device, windows=windows))
    return {"layers": layers}


def siren_apply(params: Params, cfg: SirenConfig,
                coords: torch.Tensor) -> torch.Tensor:
    """The classic SIREN's forward; stacked params give (k, n, out)."""
    layers = params["layers"]
    x = sine_layer_apply(layers[0], coords, cfg.first_omega_0)
    for p in layers[1:-1]:
        x = sine_layer_apply(p, x, cfg.hidden_omega_0)
    if cfg.outermost_linear:
        return linear_apply(layers[-1], x)
    return sine_layer_apply(layers[-1], x, cfg.hidden_omega_0)


def siren_activations(params: Params, cfg: SirenConfig,
                      coords: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every intermediate keyed by position, as the JAX package's:
    "input", then "layer{i}_pre" (omega times the pre-activation; none for
    a linear head) and "layer{i}" (the layer's output)."""
    acts: dict[str, torch.Tensor] = {"input": coords}
    x = coords.to(torch.float32)
    n = len(params["layers"])
    for i, p in enumerate(params["layers"]):
        pre = linear_apply(p, x)
        if i == n - 1 and cfg.outermost_linear:
            x = pre
        else:
            omega = cfg.first_omega_0 if i == 0 else cfg.hidden_omega_0
            acts[f"layer{i}_pre"] = omega * pre
            x = torch.sin(omega * pre)
        acts[f"layer{i}"] = x
    return acts


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
        elif kind == "scaled_sine_first":
            x = torch.sin(_row(p["omega_scale"].detach()) * pre)
        elif kind == "sine":
            x = torch.sin(cfg.hidden_omega_0 * pre)
        elif kind == "linear_snake":
            x = snake_apply(_row(p["snake_a"]), pre)
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:  # linear_last
            x = pre
    return x


def siren_snake_tanh_activations(params: Params, cfg: SirenSnakeTanhConfig,
                                 coords: torch.Tensor
                                 ) -> dict[str, torch.Tensor]:
    """Every intermediate keyed by position, as the JAX package's:
    "input", "layer{i}_pre" (a sine layer's omega times its pre-activation,
    a scaled one's per-unit product, a snake or tanh layer's
    pre-activation; none for the linear head) and "layer{i}"."""
    acts: dict[str, torch.Tensor] = {"input": coords}
    x = coords.to(torch.float32)
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds, params["layers"])):
        pre = linear_apply(p, x)
        if kind == "sine_first":
            acts[f"layer{i}_pre"] = cfg.first_omega_0 * pre
            x = torch.sin(cfg.first_omega_0 * pre)
        elif kind == "scaled_sine_first":
            scaled = _row(p["omega_scale"].detach()) * pre
            acts[f"layer{i}_pre"] = scaled
            x = torch.sin(scaled)
        elif kind == "sine":
            acts[f"layer{i}_pre"] = cfg.hidden_omega_0 * pre
            x = torch.sin(cfg.hidden_omega_0 * pre)
        elif kind == "linear_snake":
            acts[f"layer{i}_pre"] = pre
            x = snake_apply(_row(p["snake_a"]), pre)
        elif kind == "linear_tanh":
            acts[f"layer{i}_pre"] = pre
            x = torch.tanh(pre)
        else:
            x = pre
        acts[f"layer{i}"] = x
    return acts


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
