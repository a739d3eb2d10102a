"""Post-fit parameter quantization (port of ``inraudio_tpu/models/quantize.py``).

Bit-compatible with the JAX package: the same scales, the same rounding
(round half to even), the same int4 nibble packing, so a payload quantized
by either package stores identical leaves.

- ``float16`` / ``bfloat16``: a dtype cast.
- ``int8`` / ``int16``: symmetric, ``{"q": int tensor, "scale": float32}``.
- ``int4``: 15 symmetric levels packed two per byte,
  ``{"q4": uint8, "scale": float32, "shape": int32}``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..tree import tree_map

Params = Any


def _peak_scale(l: torch.Tensor, per_leading_axis: bool, levels: float,
                per_row: bool = False,
                per_last_axis: bool = False) -> torch.Tensor:
    a = l.abs()
    if per_last_axis and l.ndim >= 2:
        peak = torch.amax(a, dim=tuple(range(l.ndim - 1)), keepdim=True)
    elif per_row and l.ndim >= 3:
        peak = torch.amax(a, dim=tuple(range(1, l.ndim - 1)), keepdim=True)
    elif per_leading_axis and l.ndim >= 2:
        peak = torch.amax(a, dim=tuple(range(1, l.ndim)), keepdim=True)
    else:
        peak = torch.amax(a)
    return torch.clamp_min(peak, 1e-12) / levels


def quantize_params(params: Params, mode: str = "float16",
                    per_leading_axis: bool = False,
                    per_row: bool = False,
                    per_last_axis: bool = False) -> Params:
    """Quantize every leaf; mode in {'float16', 'bfloat16', 'int8', 'int16',
    'int4'}.  Granularity flags as in the JAX package: ``per_leading_axis``
    one scale per window, ``per_row`` one per (window, output unit),
    ``per_last_axis`` (int8 / int16) one per trailing-axis column, the
    grain of a modulation matrix (windows, mod_dim)."""
    if mode in ("float16", "bfloat16"):
        dt = torch.float16 if mode == "float16" else torch.bfloat16
        return tree_map(lambda l: l.to(dt), params)
    if mode in ("int8", "int16"):
        levels = 127.0 if mode == "int8" else 32767.0
        dt = torch.int8 if mode == "int8" else torch.int16

        def q(l):
            l = l.to(torch.float32)
            scale = _peak_scale(l, per_leading_axis, levels, per_row,
                                per_last_axis)
            return {"q": torch.clamp(torch.round(l / scale), -levels,
                                     levels).to(dt),
                    "scale": scale}
        return tree_map(q, params)
    if mode == "int4":
        def q4(l):
            l = l.to(torch.float32)
            scale = _peak_scale(l, per_leading_axis, 7.0, per_row)
            qv = torch.clamp(torch.round(l / scale), -7.0, 7.0) + 8.0
            flat = qv.to(torch.uint8).reshape(-1)
            if flat.shape[0] % 2:
                # pad nibble encodes 0 (offset 8)
                flat = torch.cat([flat, flat.new_full((1,), 8)])
            packed = (flat[0::2] << 4) | flat[1::2]
            return {"q4": packed, "scale": scale,
                    "shape": torch.tensor(l.shape, dtype=torch.int32)}
        return tree_map(q4, params)
    raise ValueError(f"unknown quantization mode {mode!r}")


def _is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"q", "scale"},
                                              {"q4", "scale", "shape"})


def dequantize_params(qparams: Params,
                      device: torch.device | str | None = None) -> Params:
    """Inverse of ``quantize_params`` -> float32 leaves, computed on
    ``device`` (default: where each leaf lies)."""
    def dq(x):
        if _is_quantized_leaf(x) and "q4" in x:
            shape = tuple(int(s) for s in x["shape"].tolist())
            n = math.prod(shape)
            packed = x["q4"].to(device)
            hi = (packed >> 4).to(torch.int32)
            lo = (packed & 0xF).to(torch.int32)
            flat = torch.stack([hi, lo], dim=1).reshape(-1)[:n]
            vals = (flat - 8).to(torch.float32).reshape(shape)
            return vals * x["scale"].to(device, torch.float32)
        if _is_quantized_leaf(x):
            return x["q"].to(device).to(torch.float32) * x["scale"].to(device)
        return x.to(device).to(torch.float32)

    return tree_map(dq, qparams, is_leaf=_is_quantized_leaf)
