"""Model zoo and factory (port of ``inraudio_tpu/models/__init__.py``):
the production SirenWithSnakeTanh ('mlp', with its scaled-sine first
layer), the classic SIREN ('siren'), the KAN ('kan'), the leaky-ReLU MLP
('relu'), the input encodings, and the ``INRModel`` fields the fit and
decode paths use."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..tree import tree_leaves
from .activations import sine_activation, snake_apply, snake_init
from .encodings import (num_frequencies_nyquist, posenc_nerf,
                        posenc_output_dim, rff_apply, rff_init,
                        rff_output_dim)
from .kan import (KANConfig, b_splines, curve2coeff, kan_apply, kan_init,
                  kan_linear_apply, kan_linear_init, kan_linear_update_grid,
                  kan_regularization_loss, kan_update_grid)
from .quantize import dequantize_params, quantize_params
from .relu import ReluMLPConfig, relu_mlp_apply, relu_mlp_init
from .siren import (SirenConfig, SirenSnakeTanhConfig, linear_apply,
                    linear_init, params_from_jax, params_to_numpy,
                    scaled_sine_layer_apply, scaled_sine_layer_init,
                    sine_layer_apply, sine_layer_init, siren_activations,
                    siren_apply, siren_init, siren_snake_tanh_activations,
                    siren_snake_tanh_apply, siren_snake_tanh_init)

__all__ = ["INRModel", "KANConfig", "ReluMLPConfig", "SirenConfig",
           "SirenSnakeTanhConfig", "b_splines", "build_model", "curve2coeff",
           "dequantize_params", "kan_apply", "kan_init", "kan_linear_apply",
           "kan_linear_init", "kan_linear_update_grid",
           "kan_regularization_loss", "kan_update_grid", "linear_apply",
           "linear_init", "num_frequencies_nyquist", "param_bytes",
           "param_count", "params_from_jax", "params_to_numpy", "posenc_nerf",
           "posenc_output_dim", "quantize_params", "relu_mlp_apply",
           "relu_mlp_init", "rff_apply", "rff_init", "rff_output_dim",
           "scaled_sine_layer_apply", "scaled_sine_layer_init",
           "sine_activation", "sine_layer_apply", "sine_layer_init",
           "siren_activations", "siren_apply", "siren_init",
           "siren_snake_tanh_activations", "siren_snake_tanh_apply",
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
    rff_b, step), which routes mse fits through the whole-step kernel:
    ``step`` is ``ops.siren_step.fused_mse_step_call``.
    ``update_grid(params, x)`` is the KAN's data-adaptive knot refresh
    (``kan_update_grid``), called by ``train.loop.fit`` between rounds.
    None where the model has no such path."""

    name: str
    config: Any
    init: Callable[..., Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    decode_apply: Callable[[Any, torch.Tensor, float], torch.Tensor] | None = None
    apply_stacked: Callable[[Any, torch.Tensor], torch.Tensor] | None = None
    decode_apply_stacked: (Callable[[Any, torch.Tensor, float], torch.Tensor]
                           | None) = None
    fused_step_ctx: dict[str, Any] | None = None
    update_grid: Callable[[Any, torch.Tensor], Any] | None = None


def build_model(arch: str, cfg: Any = None, fused: bool = False,
                approx_sin: bool = False, rff_b: torch.Tensor | None = None,
                **overrides) -> INRModel:
    """arch in {'mlp', 'siren', 'kan', 'relu'}; ``cfg`` None takes the
    arch's config built from ``overrides`` (its defaults when none).

    arch 'mlp' = the production SirenWithSnakeTanh.  ``fused=True``
    routes the forward through the stack kernel and its backward through
    kernel C (``ops.siren_fused``, ``ops.siren_train``: CUDA on a card,
    their plain versions on the CPU), and training steps through kernel D;
    ``approx_sin`` picks the polynomial sin for the untiered apply.
    ``rff_b`` (F, d): the mlp OWNS a Gaussian Fourier encoding, so apply
    takes raw coordinates and ``cfg.in_features`` is 2F; fused, the
    encoding is folded into the kernels' layer 0 (and the model has no
    stacked forms, as in the JAX package), unfused it is ``rff_apply``.

    arch 'kan' = the KAN of ``cfg`` (a ``KANConfig``); ``fused=True`` routes
    its forward through kernel G and its backward through kernel H
    (``ops.kan_fused``).  A fused mlp with the scaled-sine first layer
    raises: the kernels have no scaled-sine layer 0 (the JAX package
    unfuses it silently); unfused, it fits by autograd.

    arch 'siren' = the classic SIREN (``SirenConfig``), 'relu' = the
    leaky-ReLU MLP (``ReluMLPConfig``): plain PyTorch models; ``fused`` and
    ``rff_b`` raise for them (no kernel computes them)."""
    if arch == "kan":
        if rff_b is not None:
            raise ValueError("a KAN takes its encoded features as input; "
                             "rff_b is an mlp option")
        return _build_kan(cfg or KANConfig(**overrides), fused)
    if arch in ("siren", "relu"):
        if fused or rff_b is not None:
            raise ValueError(f"arch {arch!r} has no kernels and owns no "
                             "encoding: fused and rff_b are mlp / kan "
                             "options")
        return _build_plain(arch, cfg, overrides)
    if arch != "mlp":
        raise ValueError(f"unknown arch {arch!r} ('mlp', 'siren', 'kan', "
                         "'relu')")
    cfg = cfg or SirenSnakeTanhConfig(**overrides)
    if fused and cfg.scaled_first:
        raise NotImplementedError(
            "a fused mlp has no scaled-sine layer 0 in its kernels; fit the "
            "scaled-first mlp with fused=False")

    def init(generator: torch.Generator, device="cpu", windows=None):
        return siren_snake_tanh_init(generator, cfg, device, windows)

    if not fused:
        if rff_b is not None:
            return INRModel(name="siren_snake_tanh_rff", config=cfg,
                            init=init,
                            apply=lambda p, c: siren_snake_tanh_apply(
                                p, cfg, rff_apply(rff_b, c)))
        return INRModel(name="siren_snake_tanh", config=cfg, init=init,
                        apply=lambda p, c: siren_snake_tanh_apply(p, cfg, c))

    from ..ops.siren_fused import (auto_decode_kwargs, fused_siren_apply,
                                   fused_siren_apply_stacked)
    from ..ops.siren_step import fused_mse_step_call
    from ..ops.siren_train import fused_siren_train_apply

    def tier(fit_snr_db):
        return auto_decode_kwargs(fit_snr_db, first_omega_0=cfg.first_omega_0)

    rff = rff_b is not None
    return INRModel(
        name="siren_snake_tanh_fused_rff" if rff else "siren_snake_tanh_fused",
        config=cfg, init=init,
        apply=lambda p, c: fused_siren_train_apply(
            p, cfg, c, approx_sin=approx_sin, rff_b=rff_b),
        decode_apply=lambda p, c, fit: fused_siren_apply(
            p, cfg, c, rff_b=rff_b, **tier(fit)),
        apply_stacked=None if rff else (
            lambda P, c: fused_siren_apply_stacked(P, cfg, c,
                                                   approx_sin=approx_sin)),
        decode_apply_stacked=None if rff else (
            lambda P, c, fit: fused_siren_apply_stacked(P, cfg, c,
                                                        **tier(fit))),
        fused_step_ctx=dict(cfg=cfg, approx_sin=approx_sin, rff_b=rff_b,
                            step=fused_mse_step_call))


def _build_plain(arch: str, cfg, overrides) -> INRModel:
    """The classic SIREN or the leaky-ReLU MLP on autograd."""
    if arch == "siren":
        cfg = cfg or SirenConfig(**overrides)
        init_fn, apply_fn, name = siren_init, siren_apply, "siren"
    else:
        cfg = cfg or ReluMLPConfig(**overrides)
        init_fn, apply_fn, name = relu_mlp_init, relu_mlp_apply, "relu_mlp"

    def init(generator: torch.Generator, device="cpu", windows=None):
        return init_fn(generator, cfg, device, windows)

    return INRModel(name=name, config=cfg, init=init,
                    apply=lambda p, c: apply_fn(p, cfg, c))


def _build_kan(cfg: KANConfig, fused: bool) -> INRModel:
    def init(generator: torch.Generator, device="cpu", windows=None):
        if windows is not None:
            raise ValueError("a KAN trains as one model, not a window "
                             "population")
        return kan_init(generator, cfg, device)

    update = lambda p, c: kan_update_grid(p, cfg, c)  # noqa: E731
    if not fused:
        return INRModel(name="kan", config=cfg, init=init,
                        apply=lambda p, c: kan_apply(p, cfg, c),
                        update_grid=update)
    from ..ops.kan_fused import fused_kan_apply
    return INRModel(name="kan_fused", config=cfg, init=init,
                    apply=lambda p, c: fused_kan_apply(p, cfg, c),
                    update_grid=update)


def param_count(params: Any) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params: Any) -> int:
    """Parameter and buffer bytes, the reference's ``total_model_size``."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
