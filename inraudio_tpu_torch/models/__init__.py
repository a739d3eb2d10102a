"""Model factory (port of the ``build_model("mlp")`` part of
``inraudio_tpu/models/__init__.py``): the production SirenWithSnakeTanh and
the ``INRModel`` fields the decode path uses.  The other architectures are
not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .activations import snake_apply, snake_init
from .quantize import dequantize_params, quantize_params
from .siren import (SirenSnakeTanhConfig, params_from_jax, params_to_numpy,
                    siren_snake_tanh_apply, siren_snake_tanh_init)

__all__ = ["INRModel", "SirenSnakeTanhConfig", "build_model",
           "dequantize_params", "params_from_jax", "params_to_numpy",
           "quantize_params", "siren_snake_tanh_apply",
           "siren_snake_tanh_init", "snake_apply", "snake_init"]


@dataclasses.dataclass(frozen=True)
class INRModel:
    """A model as data.

    ``init(generator, device)`` -> params; ``apply(params, coords)`` -> out
    (stacked params give (k, n, out)), differentiable under autograd.  The
    fused variant also sets ``decode_apply(params, coords, fit_snr_db)``, the
    quality-gated tier (``ops.siren_fused.auto_decode_kwargs``), the stacked
    forms ``apply_stacked`` / ``decode_apply_stacked`` over a window
    population on one grid, and ``fused_step_ctx`` = dict(cfg, approx_sin,
    step), which routes mse fits through the whole-step kernel: ``step`` is
    ``ops.siren_step.fused_mse_step_call``.  None where the model has no
    such path."""

    name: str
    config: Any
    init: Callable[..., Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    decode_apply: Callable[[Any, torch.Tensor, float], torch.Tensor] | None = None
    apply_stacked: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    decode_apply_stacked: (Callable[[Any, torch.Tensor, float], torch.Tensor]
                           | None) = None
    fused_step_ctx: dict[str, Any] | None = None


def build_model(arch: str, cfg: SirenSnakeTanhConfig, fused: bool = False,
                approx_sin: bool = False) -> INRModel:
    """arch 'mlp' = the production SirenWithSnakeTanh.  ``fused=True``
    routes the forward through the stack kernel and its backward through
    kernel C (``ops.siren_fused``, ``ops.siren_train``: CUDA on a card,
    their plain versions on the CPU), and training steps through kernel D;
    ``approx_sin`` picks the polynomial sin for the untiered apply."""
    if arch != "mlp":
        raise ValueError(f"arch {arch!r} is not ported yet (only 'mlp')")

    def init(generator: torch.Generator, device="cpu", windows=None):
        return siren_snake_tanh_init(generator, cfg, device, windows)

    if not fused:
        return INRModel(name="siren_snake_tanh", config=cfg, init=init,
                        apply=lambda p, c: siren_snake_tanh_apply(p, cfg, c))

    from ..ops.siren_fused import (auto_decode_kwargs, fused_siren_apply,
                                   fused_siren_apply_stacked)
    from ..ops.siren_step import fused_mse_step_call
    from ..ops.siren_train import fused_siren_train_apply

    def tier(fit_snr_db):
        return auto_decode_kwargs(fit_snr_db, first_omega_0=cfg.first_omega_0)

    return INRModel(
        name="siren_snake_tanh_fused", config=cfg, init=init,
        apply=lambda p, c: fused_siren_train_apply(p, cfg, c,
                                                   approx_sin=approx_sin),
        decode_apply=lambda p, c, fit: fused_siren_apply(p, cfg, c,
                                                         **tier(fit)),
        apply_stacked=lambda P, c: fused_siren_apply_stacked(
            P, cfg, c, approx_sin=approx_sin),
        decode_apply_stacked=lambda P, c, fit: fused_siren_apply_stacked(
            P, cfg, c, **tier(fit)),
        fused_step_ctx=dict(cfg=cfg, approx_sin=approx_sin,
                            step=fused_mse_step_call))
