"""SirenWithSnakeTanh in plain float32 PyTorch, after senyuanfan/inr-for-audio
models.py (``SineLayer``, ``Snake``, ``SirenWithSnakeTanh``), and its
initial weights drawn on the device from the run's seed.

Layers: a first ``SineLayer`` sin(omega0 (x W + b)), ``num_sine`` hidden
sine layers sin(hidden_omega (x W + b)), ``num_snake`` linear layers with
Snake x + (1/a) sin^2(a x), ``num_tanh`` linear layers with tanh, and a
linear head.  Weights are stored (in, out), as the port's parameter tree.

Initial weights (models.py): the first layer W ~ U(-1/in, 1/in), hidden
sine layers U(-sqrt(6/in)/hidden_omega, +), snake and tanh layers
``nn.Linear``'s default U(-1/sqrt(in), +), the head the hidden sine bound,
every bias U(-1/sqrt(in), +), Snake's a the constant ``a_initial``.

Departures: none in the equations.  The weights come from one
``torch.rand`` call on the device (the reference draws them layer by
layer on the host), so the numbers differ for a seed; the distributions
are the reference's.
"""

from __future__ import annotations

import math

import torch

from .common import matmul


def layer_kinds(cfg: dict) -> list[str]:
    kinds = ["linear_snake" if cfg["first_linear"] else "sine_first"]
    kinds += ["sine"] * cfg["num_sine"]
    kinds += ["linear_snake"] * cfg["num_snake"]
    kinds += ["linear_tanh"] * cfg["num_tanh"]
    kinds += ["linear_last" if cfg["last_linear"] else "sine"]
    return kinds


def _bounds(cfg: dict) -> list[tuple[int, int, float, str]]:
    h = cfg["hidden_features"]
    kinds = layer_kinds(cfg)
    out = []
    for i, kind in enumerate(kinds):
        din = cfg["in_features"] if i == 0 else h
        dout = cfg["out_features"] if i == len(kinds) - 1 else h
        if kind == "sine_first":
            bound = 1.0 / din
        elif kind in ("sine", "linear_last"):
            bound = math.sqrt(6.0 / din) / cfg["hidden_omega_0"]
        else:
            bound = 1.0 / math.sqrt(din)
        out.append((din, dout, bound, kind))
    return out


def init(cfg: dict, generator: torch.Generator,
         device: torch.device) -> dict:
    """The initial parameter tree, drawn in one call from ``generator`` (a
    generator on ``device``)."""
    shapes = _bounds(cfg)
    total = sum(din * dout + dout for din, dout, _, _ in shapes)
    u = torch.rand(total, generator=generator, device=device,
                   dtype=torch.float32) * 2.0 - 1.0
    layers, off = [], 0
    for din, dout, bound, kind in shapes:
        w = u[off:off + din * dout].view(din, dout) * bound
        off += din * dout
        b = u[off:off + dout] * (1.0 / math.sqrt(din))
        off += dout
        layer = {"w": w.contiguous(), "b": b.contiguous()}
        if kind == "linear_snake":
            layer["snake_a"] = torch.full((dout,), float(cfg["a_initial"]),
                                          dtype=torch.float32, device=device)
        layers.append(layer)
    return {"layers": layers}


def forward(params: dict, cfg: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """(n, in) -> (n, out) in float32 (``tf32``: every product's operands
    rounded to TF32, the control)."""
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        pre = matmul(x, p["w"], tf32) + p["b"]
        if kind == "sine_first":
            x = torch.sin(cfg["first_omega_0"] * pre)
        elif kind == "sine":
            x = torch.sin(cfg["hidden_omega_0"] * pre)
        elif kind == "linear_snake":
            a = p["snake_a"]
            x = pre + (1.0 / a) * torch.square(torch.sin(a * pre))
        elif kind == "linear_tanh":
            x = torch.tanh(pre)
        else:
            x = pre
    return x


def frozen(params: dict) -> set[str]:
    """No buffers: every leaf trains."""
    return set()
