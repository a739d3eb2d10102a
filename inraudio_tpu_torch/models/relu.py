"""The leaky-ReLU MLP baseline (port of ``inraudio_tpu/models/relu.py``).

The reference's "ReLU" MLP passes its ``nn.LeakyReLU(0.01)`` as
``nn.Linear``'s bias flag, so it applies no nonlinearity: a deep linear
network.  As in the JAX package, the leaky ReLU is applied here;
``negative_slope=1.0`` reproduces the reference's deep-linear network.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .siren import linear_apply, linear_init

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ReluMLPConfig:
    in_features: int = 1
    hidden_features: int = 256
    hidden_layers: int = 3
    out_features: int = 1
    negative_slope: float = 0.01


def relu_mlp_init(generator: torch.Generator, cfg: ReluMLPConfig,
                  device: torch.device | str = "cpu",
                  windows: int | None = None) -> Params:
    """torch ``nn.Linear``'s default init for every layer: W and b ~
    U(-1/sqrt(in), 1/sqrt(in)), drawn from ``generator``."""
    dims = ([cfg.in_features] + [cfg.hidden_features] * (cfg.hidden_layers + 1)
            + [cfg.out_features])
    return {"layers": [linear_init(generator, i, o, 1.0 / math.sqrt(i),
                                   device=device, windows=windows)
                       for i, o in zip(dims[:-1], dims[1:])]}


def relu_mlp_apply(params: Params, cfg: ReluMLPConfig,
                   coords: torch.Tensor) -> torch.Tensor:
    x = coords.to(torch.float32)
    for p in params["layers"][:-1]:
        x = torch.nn.functional.leaky_relu(linear_apply(p, x),
                                           cfg.negative_slope)
    return linear_apply(params["layers"][-1], x)
