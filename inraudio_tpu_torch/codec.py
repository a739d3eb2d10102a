"""Audio <-> INR payload: the codec (port of ``inraudio_tpu/codec.py``).

``encode`` splits a clip into windows, fits one SirenWithSnakeTanh per
window with all windows trained at once (``train.multi_inr``: the
whole-step kernel D on a card when ``CodecConfig.fused``), keeps each
window's best parameters, optionally quantizes them (and refits the float32
leaves around the frozen quantized weights, with kernel C's backward), and
returns the payload.

A payload is ``{"meta": dict, "scales": (k,) float32 numpy, "params":
tree}``: the header the JAX package writes (format ``inraudio_tpu.inr.v2``),
the per-window peak scales, and the stacked per-window parameters in the
JAX layout as CPU tensors (quantized leaves as stored).  Files written by
either package load in the other: the INRA container and the legacy
``.npz`` keep the JAX package's leaf order (dict keys sorted, as
``jax.tree_util`` flattens them) and its per-leaf codings.

``encode_modulated`` is the shared-backbone family: one SirenSnakeTanh for
the clip (or one per ``segment_s`` segment) and a per-window modulation
vector (``models.modulated``, ``train.modulated``), with per-column int8 /
int16 modulations and a quantization-aware backbone refit.

``decode`` / ``decode_range`` / ``decode_stream`` dequantize on the target
device, evaluate the window population (through the stack kernel for
fused-trained payloads on a card, the exact apply otherwise, the modulated
forward for modulated payloads) and overlap-add on the host;
``decode_many`` evaluates compatible payloads in one stacked call.
``config_for_bitrate`` / ``plan_for_bitrate`` pick an operating point for a
bits/sample target from the JAX package's rate-distortion tables.
"""

from __future__ import annotations

import dataclasses
import json
import lzma
import os
import zlib
from typing import Any

import numpy as np
import torch

from .data.coords import get_coord
from .device import resolve_device as _resolve_device
from .models import (SirenSnakeTanhConfig, build_model, dequantize_params,
                     quantize_params)
from .models.modulated import mod_dim, modulated_apply
from .models.siren import tensor_from_numpy
from .ops.siren_fused import (auto_decode_kwargs, kernel_width, pad_params,
                              unpad_params)
from .parallel.mesh import Mesh, resolve_mesh
from .train.loop import TrainConfig
from .train.modulated import modulated_fit
from .train.multi_inr import (MultiINRConfig, batched_chunk_eval,
                              chunk_eval_fn, chunk_signal,
                              decode_chunk_range, multi_inr_fit_many,
                              stitch_chunks)
from .train.optim import AdamConfig, adam_init, adam_update
from .tree import tree_leaves, tree_map, tree_unflatten

# v2: layer-0 weights/biases stay float32 under quantization
_FORMAT = "inraudio_tpu.inr.v2"


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Encode-side knobs, with the JAX package's names and defaults; the
    decode side reads everything from the file."""

    chunk_seconds: float = 0.25
    overlap_fraction: float = 0.1
    hidden_features: int = 128
    num_sine: int = 2
    num_snake: int = 2
    first_omega_0: float = 1800.0
    hidden_omega_0: float = 30.0
    learning_rate: float = 7e-4
    grad_clip_norm: float = 1.0
    total_steps: int = 3000
    plateau_patience: int = 200
    plateau_factor: float = 0.8
    quantize: str | None = "float16"   # None | float16 | bfloat16 | int8 | int16 | int4
    per_row_scales: bool = False
    # 'auto': float16 side leaves only below _SIDE_AUTO_DB estimated fit SNR
    side_quantize: bool | str = "auto"
    fused: bool = False                # the CUDA kernels (plain on the CPU)
    seed: int = 0
    refit_steps: int = 0
    refit_lr: float = 1e-4
    max_chunks_per_batch: int | None = None


@dataclasses.dataclass(frozen=True)
class ModulatedCodecConfig:
    """Knobs of the shared-backbone codec (``encode_modulated``), with the
    JAX package's names and defaults: one SirenSnakeTanh for the clip (or
    one per ``segment_s`` seconds) plus a ``mod_dim`` vector per window."""

    chunk_seconds: float = 0.05
    overlap_fraction: float = 0.1
    hidden_features: int = 64
    num_sine: int = 2
    num_snake: int = 2
    first_omega_0: float = 500.0
    hidden_omega_0: float = 30.0
    learning_rate: float = 1e-3
    grad_clip_norm: float = 1.0
    total_steps: int = 3000
    plateau_patience: int = 200
    plateau_factor: float = 0.8
    # None | float16 | int8 | int16 | auto; int8 / int16 with one scale per
    # modulation column; 'auto' picks float16 below _MOD_AUTO_INT16_DB
    # estimated fit SNR and int16 above it
    quantize_mods: str | None = "int8"
    # backbone layers 1+ stored as float16 (layer 0 stays float32)
    shared_fp16: bool = True
    # per-unit gains as well as shifts (twice the modulation bytes)
    film_scale: bool = False
    # the modulations' learning rate as a multiple of the backbone's
    mods_lr_mult: float = 1.0
    # one backbone per ~segment_s seconds (None: one for the clip); the
    # window grid stays global
    segment_s: float | None = None
    # quantization-aware backbone refit around the frozen dequantized
    # modulations; 0 = off
    refit_backbone_steps: int = 0
    refit_lr: float = 2e-4
    seed: int = 0


# ---------------------------------------------------------------------------
# Rate planning
# ---------------------------------------------------------------------------
#
# The tables below are data copied from the JAX package (inraudio_tpu/
# codec.py:108-229).  Their bits/sample and SNR values are its calibration
# on gt_bach.wav (7 s, 44.1 kHz; the minute-scale rows on a 60 s tiling of
# it), encoded on a TPU.  None of them has been measured on the card.  Every
# knob they pin exists in CodecConfig / ModulatedCodecConfig.

_RD_CAL = dict(overlap_fraction=0.1, first_omega_0=1800.0,
               learning_rate=7e-4, per_row_scales=False, refit_steps=0)
# (bits/sample on disk, SNR dB on gt_bach.wav, knobs), TPU-calibrated
_RD_POINTS: tuple[tuple[float, float, dict[str, Any]], ...] = (
    (1.88, 19.2, dict(_RD_CAL, chunk_seconds=0.5, hidden_features=32,
                      quantize="int8", refit_steps=400)),
    (2.32, 22.3, dict(_RD_CAL, chunk_seconds=0.5, hidden_features=36,
                      quantize="int8", refit_steps=400)),
    (2.82, 25.75, dict(_RD_CAL, chunk_seconds=0.5, hidden_features=40,
                       quantize="int8", refit_steps=400)),
    (3.98, 30.6, dict(_RD_CAL, chunk_seconds=0.5, hidden_features=48,
                      quantize="int8")),
    (6.91, 32.1, dict(_RD_CAL, chunk_seconds=0.5, hidden_features=48,
                      quantize="float16")),
    (50.9, 46.3, dict(_RD_CAL, chunk_seconds=0.25, hidden_features=128,
                      quantize="int8")),
    (90.2, 60.0, dict(_RD_CAL, chunk_seconds=0.25, hidden_features=128,
                      quantize="float16")),
    (230.6, 80.0, dict(_RD_CAL, chunk_seconds=0.1, hidden_features=128,
                       first_omega_0=1000.0, learning_rate=1e-3,
                       quantize="float16")),
    (268.9, 80.6, dict(_RD_CAL, chunk_seconds=0.1, hidden_features=128,
                       first_omega_0=1000.0, learning_rate=1e-3,
                       quantize="int16", per_row_scales=True)),
    (452.9, 100.2, dict(_RD_CAL, chunk_seconds=0.1, hidden_features=128,
                        first_omega_0=1000.0, learning_rate=1e-3,
                        quantize=None)),
    (903.7, 114.4, dict(_RD_CAL, chunk_seconds=0.05, hidden_features=128,
                        first_omega_0=500.0, learning_rate=1e-3,
                        quantize=None, plateau_patience=75)),
)

# Modulated points: knobs and the SNR calibrated on a TPU; their bits/sample
# depends on the clip's length (the backbone amortises) and is priced at
# plan time by estimate_modulated_bps.  snr None = never selected.
_MOD_RD_CAL = dict(chunk_seconds=0.05, overlap_fraction=0.1,
                   first_omega_0=500.0, learning_rate=1e-3,
                   mods_lr_mult=5.0)
_MOD_RD_POINTS: tuple[tuple[str, float | None, dict[str, Any]], ...] = (
    ("mod_h48_i8", 15.4, dict(_MOD_RD_CAL, hidden_features=48,
                              quantize_mods="int8",
                              refit_backbone_steps=400)),
    ("mod_h64_i8", 19.1, dict(_MOD_RD_CAL, hidden_features=64,
                              quantize_mods="int8",
                              refit_backbone_steps=400)),
    ("mod_seg1_h96_i16", 31.6, dict(_MOD_RD_CAL, hidden_features=96,
                                    segment_s=1.0, quantize_mods="int16")),
    ("mod_seg1_h128_i16", 40.8, dict(_MOD_RD_CAL, hidden_features=128,
                                     segment_s=1.0, quantize_mods="int16")),
)

# Past _MOD_LONG_CLIP_S seconds a whole-clip backbone spans more content
# than its 7 s calibration: the planner uses the 60 s measurement where the
# JAX package has one (TPU), else derates by its measured delta.
_MOD_LONG_CLIP_S = 20.0
_MOD_SNR_60S = {"mod_h64_i8": 16.77}
_MOD_LONG_DERATE_DB = 19.1 - 16.77


def config_for_bitrate(target_bits_per_sample: float,
                       base: CodecConfig | None = None) -> CodecConfig:
    """The per-window point with the highest SNR whose bits/sample fits the
    target within 5% (the cheapest point if none fits); ``base`` carries
    every knob the table does not pin.  Per-window points only;
    ``plan_for_bitrate`` also considers the modulated family."""
    base = base or CodecConfig()
    chosen = _RD_POINTS[0][2]
    for bps, _snr, knobs in _RD_POINTS:
        if bps <= target_bits_per_sample * 1.05:
            chosen = knobs
    return dataclasses.replace(base, **chosen)


def estimate_modulated_bps(cfg: ModulatedCodecConfig, n_samples: int,
                           sample_rate: int, channels: int = 1) -> float:
    """The in-memory bits/sample an ``encode_modulated`` payload of this
    shape holds (modulations + their column scales + stored backbones +
    window scales), by arithmetic alone."""
    n = int(round(cfg.chunk_seconds * sample_rate))
    hop = max(n - int(round(cfg.overlap_fraction * n)), 1)
    k = max(1, int(np.ceil(max(n_samples - n, 0) / hop)) + 1)
    kc = k * channels
    model_cfg = SirenSnakeTanhConfig(
        hidden_features=cfg.hidden_features, num_sine=cfg.num_sine,
        num_snake=cfg.num_snake)
    md = mod_dim(model_cfg, cfg.film_scale)
    quant = cfg.quantize_mods
    if quant is None:
        mods_b = kc * md * 4
    elif quant == "int8":
        mods_b = kc * md * 1 + md * 4
    else:  # float16 / int16 / auto: 2 bytes a value
        mods_b = kc * md * 2 + (md * 4 if quant in ("int16", "auto") else 0)
    if cfg.segment_s is None:
        n_seg = 1
    else:
        n_seg = max(1, min(k, int(np.ceil(
            n_samples / (cfg.segment_s * sample_rate)))))
    h = cfg.hidden_features
    kinds = model_cfg.layer_kinds
    bb = 0
    for li, kind in enumerate(kinds):
        in_f = model_cfg.in_features if li == 0 else h
        out_f = model_cfg.out_features if li == len(kinds) - 1 else h
        vals = in_f * out_f + out_f + (out_f if kind == "linear_snake" else 0)
        # _store_shared: layer 0 float32, the rest float16 under shared_fp16
        bb += vals * (4 if (li == 0 or not cfg.shared_fp16) else 2)
    total = mods_b + n_seg * bb + kc * 4
    return 8.0 * total / (n_samples * channels)


def plan_for_bitrate(target_bits_per_sample: float, n_samples: int,
                     sample_rate: int, channels: int = 1,
                     base: CodecConfig | None = None,
                     mod_base: ModulatedCodecConfig | None = None,
                     _mod_points=None
                     ) -> tuple[str, CodecConfig | ModulatedCodecConfig]:
    """The calibrated operating point, per-window or modulated, with the
    highest SNR that fits the target within 5% (the cheapest candidate if
    none fits) -> ("per_chunk", CodecConfig) or ("modulated",
    ModulatedCodecConfig).  Modulated candidates are priced at this clip's
    length (``estimate_modulated_bps`` times the 0.93 in-memory to on-disk
    factor the JAX package measured); ``base`` / ``mod_base`` carry the
    knobs the tables do not pin."""
    base = base or CodecConfig()
    mod_base = mod_base or ModulatedCodecConfig()
    cands: list[tuple[float, float, str, Any]] = []
    for bps, snr, knobs in _RD_POINTS:
        cands.append((snr, bps, "per_chunk",
                      dataclasses.replace(base, **knobs)))
    long_clip = n_samples > _MOD_LONG_CLIP_S * sample_rate
    for name, snr, knobs in (_MOD_RD_POINTS if _mod_points is None
                             else _mod_points):
        if snr is None:
            continue
        if long_clip and knobs.get("segment_s") is None:
            snr = _MOD_SNR_60S.get(name, snr - _MOD_LONG_DERATE_DB)
        mcfg = dataclasses.replace(mod_base, **knobs)
        bps = 0.93 * estimate_modulated_bps(mcfg, n_samples, sample_rate,
                                            channels)
        cands.append((snr, bps, "modulated", mcfg))
    fitting = [c for c in cands if c[1] <= target_bits_per_sample * 1.05]
    if fitting:
        _snr, _bps, kind, cfg = max(fitting, key=lambda c: c[0])
    else:
        _snr, _bps, kind, cfg = min(cands, key=lambda c: c[1])
    return kind, cfg


# float16 side leaves are free at <=44 dB fits and cost -2.75 dB at ~96 dB
# (the JAX package's measurement, on a TPU); gate at 70 dB as it does
_SIDE_AUTO_DB = 70.0

# the side leaves (biases, snake a) of layers 1+ are stored at this tier
_SIDE_MODE = {"float16": "float16", "bfloat16": "bfloat16",
              "int8": "float16", "int16": "float16", "int4": "float16"}

# The header's fit_snr_db is an estimate, bounded to +-6 dB of the measured
# reconstruction by the JAX package's tests; routing inflates it by that
# bound so an underestimate cannot land a fit on a tier whose floor sits at
# its true quality.
_FIT_EST_SLACK_DB = 6.0


def _check_format(meta: dict[str, Any]) -> None:
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"unsupported payload format {meta.get('format')!r}: this build "
            f"reads {_FORMAT} only (older payloads must be re-encoded from "
            "the source audio)")


def _model_cfg_from_meta(meta: dict[str, Any]) -> SirenSnakeTanhConfig:
    """meta['model'] -> SirenSnakeTanhConfig."""
    m = meta["model"]
    return SirenSnakeTanhConfig(
        hidden_features=m["hidden_features"], num_sine=m["num_sine"],
        num_snake=m["num_snake"], first_omega_0=m["first_omega_0"],
        hidden_omega_0=m["hidden_omega_0"])


# ---------------------------------------------------------------------------
# Quantization of the stacked window parameters
# ---------------------------------------------------------------------------

def quantize_inr_params(params: Any, mode: str, per_row: bool = False,
                        side: bool = True) -> Any:
    """Sensitivity-aware quantization: layer 0 stays float32 (it sits
    inside sin(omega0 * .)), layers 1+ weights quantize at ``mode`` with
    per-window scales, and with ``side`` their biases and snake ``a`` are
    stored at ``_SIDE_MODE``.  Bit-identical to the JAX package."""
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        if li > 0:
            new["w"] = quantize_params(layer["w"], mode,
                                       per_leading_axis=True, per_row=per_row)
        out_layers.append(new)
    out = {"layers": out_layers}
    return _quantize_sides(out, mode) if side else out


def _quantize_sides(params: Any, mode: str) -> Any:
    out_layers = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        if li > 0:
            for k, v in layer.items():
                if k != "w" and not isinstance(v, dict):
                    new[k] = quantize_params(v, _SIDE_MODE[mode],
                                             per_leading_axis=True)
        out_layers.append(new)
    return {"layers": out_layers}


def dequantize_inr_params(params: Any,
                          device: torch.device | str | None = None) -> Any:
    """Inverse of ``quantize_inr_params`` -> float32 leaves on ``device``."""
    return dequantize_params(params, device)


def _refit_trainable(model, params: Any, mode: str, targets: torch.Tensor,
                     coords: torch.Tensor, steps: int, lr: float,
                     per_row: bool = False) -> Any:
    """Core of the quantization-aware refit: Adam on the float32 leaves
    (layer-0 weights, every bias, snake a) around the FROZEN dequantized
    weight matrices of layers 1+, loss = mean squared error over the whole
    (k, n, 1) population; returns the refitted trainable tree.  A fused
    model between the kernel widths refits zero-padded to the next one
    (padded once here, unpadded at the end): the kernels give its padded
    slots exact zero gradients, so Adam leaves them at 0."""
    q = quantize_inr_params(params, mode, per_row=per_row)
    dq = dequantize_inr_params(q, coords.device)
    h = model.config.hidden_features
    width = kernel_width(h) if model.fused_step_ctx is not None else h
    dq = pad_params(dq, width)
    frozen = [layer["w"] for layer in dq["layers"][1:]]
    trainable = {"layers": [
        {k: v for k, v in layer.items() if not (li > 0 and k == "w")}
        for li, layer in enumerate(dq["layers"])]}
    adam_cfg = AdamConfig(lr=lr)
    opt = adam_init(trainable, adam_cfg)
    for _ in range(steps):
        leaves = [v.detach().requires_grad_(True)
                  for v in tree_leaves(trainable)]
        tr = tree_unflatten(trainable, leaves)
        full = {"layers": [dict(layer, **({"w": frozen[li - 1]} if li > 0
                                          else {}))
                           for li, layer in enumerate(tr["layers"])]}
        with torch.enable_grad():
            loss = torch.mean((model.apply(full, coords) - targets) ** 2)
            grads = torch.autograd.grad(loss, leaves)
        trainable, opt = adam_update(
            opt, tree_unflatten(trainable, list(grads)), trainable, adam_cfg)
    if width == h:
        return trainable
    return tree_map(torch.Tensor.contiguous, unpad_params(trainable, h))


def quantization_aware_refit(model, params: Any, mode: str,
                             targets: np.ndarray, coords: np.ndarray,
                             steps: int, lr: float = 1e-4,
                             max_chunks_per_batch: int | None = None,
                             per_row: bool = False,
                             side: bool = True) -> Any:
    """Refit the float32 leaves around frozen quantized weights.

    ``params`` is the stacked (k, ...) float32 best-params tree (on the
    device the refit runs on); ``targets`` the (k, n, 1) normalised window
    targets it was fit to.  The hidden / last weight matrices are quantized
    (``mode``) and frozen at the values the decoder reconstructs; the
    remaining float32 leaves are fine-tuned so that they absorb part of the
    quantization error.  Returns the stored-form tree (quantized weight
    dicts + refitted leaves), the structure ``load_inr`` expects.
    ``max_chunks_per_batch`` refits in batches of that many windows (each
    window's scales are its own, so a slice's frozen weights equal the full
    population's)."""
    dev = params["layers"][0]["w"].device
    c = torch.as_tensor(np.asarray(coords, np.float32)).to(dev)
    t = torch.as_tensor(np.asarray(targets, np.float32)).to(dev)
    k = t.shape[0]
    kb = max_chunks_per_batch
    if kb and k > kb:
        # the last batch repeats window 0 up to kb windows, as the JAX
        # package does: the loss is a mean over the batch
        def batch(x, s):
            x = x[s:s + kb]
            return torch.cat([x, x[:1].expand(kb - x.shape[0],
                                              *x.shape[1:])])
        parts = [tree_map(lambda x: x[:min(kb, k - s)], _refit_trainable(
            model, tree_map(lambda x: batch(x, s), params), mode,
            batch(t, s), c, steps, lr, per_row=per_row))
            for s in range(0, k, kb)]
        trainable = tree_map(lambda *xs: torch.cat(xs), *parts)
    else:
        trainable = _refit_trainable(model, params, mode, t, c, steps, lr,
                                     per_row=per_row)
    q = quantize_inr_params(params, mode, per_row=per_row, side=False)
    stored = {"layers": [
        dict(trainable["layers"][li],
             **({"w": q["layers"][li]["w"]} if li > 0 else {}))
        for li in range(len(q["layers"]))]}
    return _quantize_sides(stored, mode) if side else stored


def _split_channels(signal: np.ndarray) -> list[np.ndarray]:
    """(n,) or (n, c) float32 -> list of contiguous channel vectors."""
    sig = np.asarray(signal, np.float32)
    if sig.size == 0:
        raise ValueError("cannot encode an empty signal")
    if sig.ndim == 2 and sig.shape[1] == 1:
        sig = sig[:, 0]
    if sig.ndim == 1:
        return [sig]
    return [np.ascontiguousarray(sig[:, j]) for j in range(sig.shape[1])]


def encode(signal: np.ndarray, sample_rate: int,
           cfg: CodecConfig | None = None,
           device: torch.device | str | None = None,
           mesh: Mesh | None = None) -> dict[str, Any]:
    """Fit the multi-INR on ``device`` and return the codec payload.
    ``mesh`` (``parallel.make_mesh(device)`` when None) shards the windows
    over its ranks and places the fit (a ``device`` given beside it must be
    its own); every rank returns the same payload.

    ``signal`` is (n,) mono or (n, c): every channel's windows join one
    population, channel-major (window i of channel j at row j*k+i).  The
    payload's header and leaves are those the JAX package's ``encode``
    writes; ``trained_forward`` is 'fused_approx' for a fused fit (the
    kernels' bf16x3 matmuls and polynomial sin) and 'exact' otherwise."""
    cfg = cfg or CodecConfig()
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    model_cfg = SirenSnakeTanhConfig(
        hidden_features=cfg.hidden_features, num_sine=cfg.num_sine,
        num_snake=cfg.num_snake, first_omega_0=cfg.first_omega_0,
        hidden_omega_0=cfg.hidden_omega_0)
    model = build_model("mlp", model_cfg, fused=cfg.fused,
                        approx_sin=cfg.fused)
    chans = _split_channels(signal)
    mcfg = MultiINRConfig(chunk_seconds=cfg.chunk_seconds,
                          overlap_fraction=cfg.overlap_fraction)
    results = multi_inr_fit_many(
        model, chans, sample_rate, mcfg,
        TrainConfig(total_steps=cfg.total_steps,
                    learning_rate=cfg.learning_rate,
                    grad_clip_norm=cfg.grad_clip_norm,
                    plateau_patience=cfg.plateau_patience,
                    plateau_factor=cfg.plateau_factor),
        seed=cfg.seed, max_chunks_per_batch=cfg.max_chunks_per_batch,
        mesh=mesh)
    res = results[0]
    params = tree_map(lambda *xs: torch.cat(xs).to(dev),
                      *[r.states.best_params for r in results])
    scales = np.concatenate([r.chunk_scales for r in results])

    # fit SNR estimate from the per-window best train losses (the best
    # snapshot is what ships): unnormalised mse = best_loss * scale^2
    fit_snr = None
    if res.loss_history.size:
        best_mses = np.concatenate(
            [np.min(r.loss_history, axis=0) for r in results])
        pw = float(np.mean(np.concatenate(
            [np.asarray(c, np.float32).reshape(-1) ** 2 for c in chans])))
        mse = float(np.mean(best_mses * scales.astype(np.float64) ** 2))
        fit_snr = round(10.0 * np.log10(max(pw, 1e-30) / max(mse, 1e-30)), 2)
    side = (cfg.side_quantize if isinstance(cfg.side_quantize, bool)
            else fit_snr is not None and fit_snr < _SIDE_AUTO_DB)
    if cfg.quantize and cfg.refit_steps > 0:
        chunks = np.concatenate(
            [chunk_signal(ch, sample_rate, mcfg)[0] for ch in chans], axis=0)
        targets = (chunks / scales[:, None])[..., None]
        stored = quantization_aware_refit(
            model, params, cfg.quantize, targets,
            get_coord(res.chunk_length, dim=1), cfg.refit_steps, cfg.refit_lr,
            max_chunks_per_batch=cfg.max_chunks_per_batch,
            per_row=cfg.per_row_scales, side=side)
    elif cfg.quantize:
        stored = quantize_inr_params(params, cfg.quantize,
                                     per_row=cfg.per_row_scales, side=side)
    else:
        stored = params
    meta = {
        "format": _FORMAT,
        "sample_rate": int(sample_rate),
        "signal_length": int(res.signal_length),
        "chunk_length": int(res.chunk_length),
        "hop": int(res.hop),
        "num_chunks": int(res.num_chunks),
        "num_channels": len(chans),
        "quantize": cfg.quantize,
        "per_row_scales": bool(cfg.per_row_scales),
        "side_quantized": bool(cfg.quantize and side),
        "trained_forward": "fused_approx" if cfg.fused else "exact",
        **({"fit_snr_db": fit_snr} if fit_snr is not None else {}),
        "model": {
            "hidden_features": cfg.hidden_features,
            "num_sine": cfg.num_sine, "num_snake": cfg.num_snake,
            "first_omega_0": cfg.first_omega_0,
            "hidden_omega_0": cfg.hidden_omega_0,
        },
    }
    return {"meta": meta, "scales": scales.astype(np.float32),
            "params": tree_map(lambda x: x.detach().cpu(), stored)}


def param_bytes(params: Any) -> int:
    """Bytes of every leaf (tensor or array) of a parameter tree."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in tree_leaves(params))


def compression_stats(payload: dict[str, Any],
                      path: str | None = None) -> dict[str, float]:
    """Bytes, bits/sample and ratio against 16-bit PCM; with ``path`` (a
    file ``save_inr`` wrote) also the on-disk numbers."""
    nbytes = param_bytes(payload["params"]) + payload["scales"].nbytes
    n = (payload["meta"]["signal_length"]
         * int(payload["meta"].get("num_channels", 1)))
    pcm16 = 2 * n
    stats = {"param_bytes": float(nbytes),
             "bits_per_sample": 8.0 * nbytes / n,
             "ratio_vs_pcm16": pcm16 / nbytes}
    if path is not None:
        fb = os.path.getsize(path)
        stats["file_bytes"] = float(fb)
        stats["file_bits_per_sample"] = 8.0 * fb / n
        stats["file_ratio_vs_pcm16"] = pcm16 / fb
    return stats


# ---------------------------------------------------------------------------
# The modulated (shared-backbone) family
# ---------------------------------------------------------------------------

# 'auto' modulation tier: float16 modulations cap the reconstruction near
# 76 dB (the JAX package's measurement, on a TPU); int16 takes over above a
# 70 dB estimated fit
_MOD_AUTO_INT16_DB = 70.0


def _store_shared(shared: Any, fp16: bool) -> Any:
    """A float32 backbone -> its stored form, CPU tensors: layer 0 stays
    float32 (it sits inside sin(omega0 * .)), layers 1+ float16 under
    ``fp16``."""
    layers = [{k: v.detach().cpu() for k, v in layer.items()}
              for layer in shared["layers"]]
    if fp16:
        layers = layers[:1] + [{k: v.to(torch.float16)
                                for k, v in layer.items()}
                               for layer in layers[1:]]
    return {"layers": layers}


def _load_shared(shared: Any, device: torch.device) -> Any:
    """A stored backbone -> float32 tensors on ``device``."""
    return tree_map(lambda x: x.to(device, torch.float32), shared)


def _auto_mod_tier(fit_mses: list[float], fit_powers: list[float],
                   fit_weights: list[int]) -> str:
    """float16 or int16 modulations from the fit's own quality: fit SNR ~=
    10 log10(target power / best MSE), window-count weighted over
    segments."""
    w = np.asarray(fit_weights, np.float64)
    mse = float(np.sum(np.asarray(fit_mses) * w) / np.sum(w))
    power = float(np.sum(np.asarray(fit_powers) * w) / np.sum(w))
    fit_snr = 10.0 * np.log10(power / max(mse, 1e-30))
    return "int16" if fit_snr > _MOD_AUTO_INT16_DB else "float16"


def encode_modulated(signal: np.ndarray, sample_rate: int,
                     cfg: ModulatedCodecConfig | None = None,
                     device: torch.device | str | None = None
                     ) -> dict[str, Any]:
    """Fit the shared-backbone codec on ``device`` (default the card) and
    return its payload, the header and leaves the JAX package's
    ``encode_modulated`` writes.  ``signal`` is (n,) or (n, c); every
    channel's windows join one population, channel-major.  With
    ``segment_s`` each segment of the global window grid gets its own
    backbone, drawn in turn from one generator seeded with ``cfg.seed``."""
    cfg = cfg or ModulatedCodecConfig()
    if cfg.quantize_mods not in (None, "float16", "int8", "int16", "auto"):
        raise ValueError(f"quantize_mods {cfg.quantize_mods!r}: use "
                         "None | float16 | int8 | int16 | auto")
    if cfg.segment_s is not None and cfg.segment_s <= 0:
        raise ValueError(f"segment_s must be positive, got {cfg.segment_s}")
    if cfg.refit_backbone_steps > 0 and cfg.quantize_mods is None:
        raise ValueError("refit_backbone_steps needs quantized modulations "
                         "(quantize_mods float16/int8/int16) — with float mods "
                         "there is no quantization error to absorb")
    dev = _resolve_device("cuda" if device is None else device)
    chans = _split_channels(signal)
    mcfg = MultiINRConfig(chunk_seconds=cfg.chunk_seconds,
                          overlap_fraction=cfg.overlap_fraction)
    per_ch = [chunk_signal(ch, sample_rate, mcfg) for ch in chans]
    n, hop = per_ch[0][1], per_ch[0][2]
    chunks = np.concatenate([c for c, _, _ in per_ch], axis=0)
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    targets = (chunks / scales[:, None])[..., None]
    model_cfg = SirenSnakeTanhConfig(
        hidden_features=cfg.hidden_features, num_sine=cfg.num_sine,
        num_snake=cfg.num_snake, first_omega_0=cfg.first_omega_0,
        hidden_omega_0=cfg.hidden_omega_0)
    tc = TrainConfig(total_steps=cfg.total_steps,
                     learning_rate=cfg.learning_rate,
                     grad_clip_norm=cfg.grad_clip_norm,
                     plateau_patience=cfg.plateau_patience,
                     plateau_factor=cfg.plateau_factor)
    coords = get_coord(n, dim=1)
    k = per_ch[0][0].shape[0]
    c = len(chans)
    if cfg.segment_s is None:
        n_seg = 1
    else:
        n_seg = max(1, min(k, int(np.ceil(
            len(chans[0]) / (cfg.segment_s * sample_rate)))))
    # one backbone per window-index range; all channels' windows of a
    # segment fit together (bounds [0, k] for one backbone)
    bounds = [round(g * k / n_seg) for g in range(n_seg + 1)]

    def rows(x, g):
        a, b = bounds[g], bounds[g + 1]
        return np.concatenate([x[j * k + a: j * k + b] for j in range(c)],
                              axis=0)

    generator = torch.Generator().manual_seed(cfg.seed)
    md = mod_dim(model_cfg, cfg.film_scale)
    mods = np.zeros((c * k, md), np.float32)
    backbones, fit_mses, fit_powers, fit_weights = [], [], [], []
    for g in range(n_seg):
        tg = rows(targets, g)
        rg = modulated_fit(model_cfg, tg, coords, tc, generator=generator,
                           device=dev, film_scale=cfg.film_scale,
                           mods_lr_mult=cfg.mods_lr_mult)
        mg = rg.mods.cpu().numpy()
        a, b = bounds[g], bounds[g + 1]
        for j in range(c):
            mods[j * k + a: j * k + b] = mg[j * (b - a): (j + 1) * (b - a)]
        backbones.append(rg.shared)
        fit_mses.append(float(np.min(rg.loss_history)))
        fit_powers.append(float(np.mean(tg ** 2)))
        fit_weights.append(tg.shape[0])
    quant = cfg.quantize_mods
    if quant == "auto":
        quant = _auto_mod_tier(fit_mses, fit_powers, fit_weights)
    mods_t = torch.from_numpy(mods)
    if quant in ("int8", "int16"):
        stored_mods = quantize_params(mods_t, quant, per_last_axis=True)
        deq_mods = dequantize_params(stored_mods).numpy()
    elif quant == "float16":
        stored_mods = mods_t.to(torch.float16)
        deq_mods = stored_mods.to(torch.float32).numpy()
    else:  # None
        stored_mods, deq_mods = mods_t, mods
    if quant and cfg.refit_backbone_steps > 0:
        # quantization-aware backbone refit: the modulations frozen at their
        # dequantized values, each backbone absorbs part of their error
        rtc = TrainConfig(total_steps=cfg.refit_backbone_steps,
                          learning_rate=cfg.refit_lr,
                          grad_clip_norm=cfg.grad_clip_norm)
        backbones = [modulated_fit(
            model_cfg, rows(targets, g), coords, rtc, device=dev,
            frozen_mods=rows(deq_mods, g), init_shared=backbones[g],
            film_scale=cfg.film_scale).shared for g in range(n_seg)]
    stored_bb = [_store_shared(bb, cfg.shared_fp16) for bb in backbones]
    shared_stored = (stored_bb[0] if n_seg == 1 else
                     tree_map(lambda *xs: torch.stack(xs), *stored_bb))
    meta = {
        "format": _FORMAT,
        "codec": "modulated",
        "sample_rate": int(sample_rate),
        "signal_length": int(len(chans[0])),
        "chunk_length": int(n),
        "hop": int(hop),
        "num_chunks": int(k),
        "num_channels": len(chans),
        "quantize": quant,
        "shared_fp16": bool(cfg.shared_fp16),
        "mod_dim": int(md),
        "film_scale": bool(cfg.film_scale),
        "num_segments": int(n_seg),
        "segment_bounds": [int(x) for x in bounds],
        "model": {
            "hidden_features": cfg.hidden_features,
            "num_sine": cfg.num_sine, "num_snake": cfg.num_snake,
            "first_omega_0": cfg.first_omega_0,
            "hidden_omega_0": cfg.hidden_omega_0,
        },
    }
    return {"meta": meta, "scales": scales.astype(np.float32),
            "params": {"mods": stored_mods, "shared": shared_stored}}


def _modulated_decode_fn(payload: dict[str, Any], coords: torch.Tensor,
                         device: torch.device):
    """-> (eval over a window slice -> (k, n, 1), per-window params).

    The params are what ``batched_chunk_eval`` / ``decode_chunk_range``
    slice on the window axis: the modulation matrix on ``device`` for a
    one-backbone payload; for a segmented payload ``{"mod", "g"}``, ``g``
    each window's segment (host numpy).  Each run of windows of one segment
    is evaluated under that segment's backbone."""
    meta = payload["meta"]
    cfg = _model_cfg_from_meta(meta)
    shared = _load_shared(payload["params"]["shared"], device)
    mods = dequantize_params(payload["params"]["mods"], device)
    film = bool(meta.get("film_scale", False))
    n_seg = int(meta.get("num_segments", 1))
    if n_seg == 1:
        return (lambda m: modulated_apply(shared, cfg, coords, m,
                                          film_scale=film)), mods
    bounds = np.asarray(meta["segment_bounds"], np.int64)
    k = meta["num_chunks"]
    c = int(meta.get("num_channels", 1))
    g_of_i = (np.searchsorted(bounds, np.arange(k), side="right") - 1
              ).clip(0, n_seg - 1)
    backbones = [tree_map(lambda x: x[g], shared) for g in range(n_seg)]

    def fn(p):
        g = p["g"]
        cuts = [0, *(np.flatnonzero(np.diff(g)) + 1), len(g)]
        return torch.cat([modulated_apply(backbones[g[a]], cfg, coords,
                                          p["mod"][a:b], film_scale=film)
                          for a, b in zip(cuts, cuts[1:])])

    return fn, {"mod": mods, "g": np.tile(g_of_i, c)}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _routing_fit_snr(meta: dict[str, Any]) -> float | None:
    fit = meta.get("fit_snr_db")
    return None if fit is None else float(fit) + _FIT_EST_SLACK_DB


def _decode_grid(n0: int, u: int) -> np.ndarray:
    """Per-window decode grid; ``u`` > 1 subdivides the training grid
    (step 2/(n0-1)) u times, so every u-th sample sits on a training
    coordinate."""
    if u == 1:
        return np.asarray(get_coord(n0, dim=1), np.float32)
    j = np.arange(n0 * u, dtype=np.float64)
    return (-1.0 + 2.0 * j / (u * (n0 - 1)))[:, None].astype(np.float32)


def _stitch_outs(payload: dict[str, Any], outs: np.ndarray, upsample: int
                 ) -> tuple[int, np.ndarray]:
    """Scale + overlap-add one payload's raw (c*k, n, 1) window evals."""
    meta = payload["meta"]
    u = max(1, int(upsample))
    hop = meta["hop"] * u
    c = int(meta.get("num_channels", 1))
    k = meta["num_chunks"]
    outs = np.asarray(outs)[:, :, 0] * payload["scales"][:, None]
    length = meta["signal_length"] * u
    if c == 1:
        return meta["sample_rate"] * u, stitch_chunks(outs, hop, length)
    wav = np.stack([stitch_chunks(outs[j * k:(j + 1) * k], hop, length)
                    for j in range(c)], axis=1)
    return meta["sample_rate"] * u, wav


def _payload_model_params(payload: dict[str, Any], fused: bool | None,
                          device: torch.device):
    """Validate a per-window payload's header and rebuild (meta, model,
    float32 params on ``device``).

    ``fused=None`` routes through the stack kernel when the payload was
    trained under the fused forward (``trained_forward ==
    'fused_approx'``) and the device is a card; otherwise the exact apply.
    ``fused=True`` on the CPU runs the kernel's plain PyTorch version."""
    meta = payload["meta"]
    _check_format(meta)
    if fused is None:
        fused = (meta.get("trained_forward") == "fused_approx"
                 and device.type == "cuda")
    model = build_model("mlp", _model_cfg_from_meta(meta), fused=fused,
                        approx_sin=fused)
    return meta, model, dequantize_inr_params(payload["params"], device)


def _payload_eval(payload: dict[str, Any], fused: bool | None,
                  device: torch.device, upsample: int):
    """-> (meta, eval of a window slice -> (k, n*u, 1), per-window params
    on ``device``): the codec family's forward on the payload's grid."""
    meta = payload["meta"]
    coords = torch.from_numpy(
        _decode_grid(meta["chunk_length"], max(1, int(upsample)))).to(device)
    if meta.get("codec") == "modulated":
        _check_format(meta)
        fn, params = _modulated_decode_fn(payload, coords, device)
        return meta, fn, params
    meta, model, params = _payload_model_params(payload, fused, device)
    return meta, chunk_eval_fn(model, coords, _routing_fit_snr(meta)), params


def decode(payload: dict[str, Any], device: torch.device | str,
           fused: bool | None = None, upsample: int = 1,
           max_chunks_per_batch: int | None = None) -> tuple[int, np.ndarray]:
    """Payload -> (sample_rate, waveform), evaluated on ``device``.

    ``upsample`` > 1 evaluates every window on a grid that many times
    denser (bandwidth-extension decode) and returns the upsampled rate.
    ``max_chunks_per_batch`` bounds device memory for long clips."""
    dev = _resolve_device(device)
    meta, fn, params = _payload_eval(payload, fused, dev, upsample)
    ck = int(meta.get("num_channels", 1)) * meta["num_chunks"]
    outs = batched_chunk_eval(fn, params, ck, max_chunks_per_batch)
    return _stitch_outs(payload, outs, upsample)


def decode_many(payloads: list[dict[str, Any]], device: torch.device | str,
                fused: bool | None = None, upsample: int = 1,
                max_chunks_per_batch: int | None = None
                ) -> list[tuple[int, np.ndarray]]:
    """Decode several payloads on ``device`` -> (sample_rate, waveform) per
    payload, in input order, each equal to ``decode`` of that payload.

    Per-window payloads whose decode is the same computation (model recipe,
    window length, route: the model's name, which says whether the stack
    kernel runs, and the resolved decode tier) have their windows
    concatenated into one stacked evaluation: one stack-kernel call per
    group on a card.  Modulated payloads decode one at a time."""
    dev = _resolve_device(device)
    results: list[tuple[int, np.ndarray] | None] = [None] * len(payloads)
    groups: dict[Any, list] = {}
    for i, p in enumerate(payloads):
        if p["meta"].get("codec") == "modulated":
            results[i] = decode(p, dev, fused, upsample, max_chunks_per_batch)
            continue
        meta, model, params = _payload_model_params(p, fused, dev)
        fit = _routing_fit_snr(meta)
        if model.decode_apply_stacked is not None and fit is not None:
            tier = repr(sorted(auto_decode_kwargs(
                fit, first_omega_0=meta["model"].get("first_omega_0")
            ).items(), key=str))
        else:
            tier = "plain"
        key = (tuple(sorted(meta["model"].items())), meta["chunk_length"],
               model.name, tier)
        groups.setdefault(key, []).append((i, p, model, params, fit))
    for items in groups.values():
        _, p0, model0, _, fit0 = items[0]
        coords = torch.from_numpy(_decode_grid(
            p0["meta"]["chunk_length"], max(1, int(upsample)))).to(dev)
        fn = chunk_eval_fn(model0, coords, fit0)
        cks = [int(p["meta"].get("num_channels", 1)) * p["meta"]["num_chunks"]
               for _, p, _, _, _ in items]
        cat = tree_map(lambda *xs: torch.cat(xs),
                       *[params for _, _, _, params, _ in items])
        outs = batched_chunk_eval(fn, cat, sum(cks), max_chunks_per_batch)
        off = 0
        for (i, p, _, _, _), ck in zip(items, cks):
            results[i] = _stitch_outs(p, outs[off:off + ck], upsample)
            off += ck
    return results  # type: ignore[return-value]


def _range_blocks(payload, fn, params, blocks, max_chunks_per_batch):
    """Yield (start, waveform slice) for each [start, stop) of ``blocks``
    (samples), every channel stitched from the windows that cover it."""
    meta = payload["meta"]
    c = int(meta.get("num_channels", 1))
    k = meta["num_chunks"]
    scales = np.asarray(payload["scales"], np.float32)
    chans = [tree_map(lambda x: x[j * k:(j + 1) * k], params)
             for j in range(c)]
    for a, b in blocks:
        parts = [decode_chunk_range(
            fn, chans[j], scales[j * k:(j + 1) * k], meta["chunk_length"],
            meta["hop"], k, meta["signal_length"], a, b,
            max_chunks_per_batch) for j in range(c)]
        yield a, (parts[0] if c == 1 else np.stack(parts, axis=1))


def decode_range(payload: dict[str, Any], start_s: float, stop_s: float,
                 device: torch.device | str, fused: bool | None = None,
                 max_chunks_per_batch: int | None = None
                 ) -> tuple[int, np.ndarray]:
    """Random-access decode of ``[start_s, stop_s)`` seconds: only the
    windows overlapping the range are evaluated (O(range) work).  Equals the
    corresponding slice of ``decode`` (exactly on the kernel route)."""
    dev = _resolve_device(device)
    meta, fn, params = _payload_eval(payload, fused, dev, 1)
    sr = meta["sample_rate"]
    a, b = int(round(start_s * sr)), int(round(stop_s * sr))
    (_, out), = _range_blocks(payload, fn, params, [(a, b)],
                              max_chunks_per_batch)
    return sr, out


def decode_stream(payload: dict[str, Any], device: torch.device | str,
                  block_s: float = 1.0, fused: bool | None = None):
    """Generator of (start_sample, waveform block) covering the clip in
    ``block_s``-second blocks, each from only the windows that cover it;
    concatenated, the blocks equal ``decode``.  Routed like ``decode``
    (``fused=None`` auto, the header's fit-gated tier)."""
    dev = _resolve_device(device)
    meta, fn, params = _payload_eval(payload, fused, dev, 1)
    total = meta["signal_length"]
    step = max(1, int(round(block_s * meta["sample_rate"])))
    yield from _range_blocks(payload, fn, params,
                             [(a, min(a + step, total))
                              for a in range(0, total, step)], None)


def to_device(payload: dict[str, Any],
              device: torch.device | str) -> dict[str, Any]:
    """A new payload whose (still quantized) parameter leaves live on
    ``device``: a server that keeps it decodes without re-uploading the
    parameters per request.  The input payload is left as it is."""
    dev = _resolve_device(device)
    return {**payload, "params": tree_map(lambda x: x.to(dev),
                                          payload["params"])}


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

def _quantized_leaf_template(mode: str):
    if mode in ("float16", "bfloat16"):
        return mode
    if mode in ("int8", "int16"):
        return {"q": mode, "scale": "float32"}
    if mode == "int4":
        return {"q4": "uint8", "scale": "float32", "shape": "int32"}
    raise ValueError(f"unknown quantization mode {mode!r}")


def _params_template(meta: dict[str, Any]) -> dict[str, Any]:
    """The stored parameter tree's structure, leaves = stored dtype names:
    what ``quantize_inr_params`` makes of ``build_model(...).init``, or for
    a modulated payload ``{"mods", "shared"}`` as ``encode_modulated``
    stores them (leaf shapes, a segmented payload's stacked backbones too,
    come from the file)."""
    cfg = _model_cfg_from_meta(meta)
    mode = meta.get("quantize")
    modulated = meta.get("codec") == "modulated"
    side = bool(meta.get("side_quantized", False))
    layers = []
    for li, kind in enumerate(cfg.layer_kinds):
        layer: dict[str, Any] = {"w": "float32", "b": "float32"}
        if kind == "linear_snake":
            layer["snake_a"] = "float32"
        if modulated:
            if li > 0 and meta.get("shared_fp16", False):
                layer = dict.fromkeys(layer, "float16")
        elif mode and li > 0:
            for key in layer:
                if key == "w":
                    layer[key] = _quantized_leaf_template(mode)
                elif side:
                    layer[key] = _SIDE_MODE[mode]
        layers.append(layer)
    if not modulated:
        return {"layers": layers}
    mods = (_quantized_leaf_template(mode) if mode in ("int8", "int16")
            else mode or "float32")
    return {"mods": mods, "shared": {"layers": layers}}


def _leaf_bits(leaf) -> tuple[str, np.ndarray]:
    """A stored leaf -> (dtype name, numpy array of its bits); bfloat16
    travels as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return a.dtype.name, a


def _flatten_payload(payload: dict[str, Any]) -> dict[str, np.ndarray]:
    arrays = {"__meta__": np.frombuffer(
        json.dumps(payload["meta"]).encode("utf-8"), dtype=np.uint8),
        "scales": payload["scales"]}
    leaves = tree_leaves(payload["params"])
    arrays["__nleaves__"] = np.asarray(len(leaves))
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i:05d}"] = _leaf_bits(leaf)[1]
    return arrays


# ---- INRA container: per-leaf best-of lossless entropy coding ----------

_INRA_MAGIC = b"INRA1\x00"
_LZMA_FILTERS = ({"id": lzma.FILTER_LZMA2, "preset": 6},)


def _lzma_c(b: bytes) -> bytes:
    return lzma.compress(b, format=lzma.FORMAT_RAW,
                         filters=list(_LZMA_FILTERS))


def _lzma_d(b: bytes) -> bytes:
    return lzma.decompress(b, format=lzma.FORMAT_RAW,
                           filters=list(_LZMA_FILTERS))


def _byte_shuffle(b: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(b, np.uint8).reshape(-1, itemsize)
    return np.ascontiguousarray(a.T).tobytes()


def _byte_unshuffle(b: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(b, np.uint8).reshape(itemsize, -1)
    return np.ascontiguousarray(a.T).tobytes()


def _encode_leaf(leaf) -> tuple[dict[str, Any], bytes]:
    """-> (spec, blob).  Lossless; keeps the smallest applicable coding of
    the same candidate set as the JAX package, so both write equal files."""
    dtype, bits = _leaf_bits(leaf)
    raw = bits.tobytes()
    cands: dict[str, bytes] = {"raw": raw}
    if len(raw) >= 256:
        cands["zlib"] = zlib.compress(raw, 9)
        cands["lzma"] = _lzma_c(raw)
        if bits.dtype.itemsize > 1:
            sh = _byte_shuffle(raw, bits.dtype.itemsize)
            cands["shuf+zlib"] = zlib.compress(sh, 9)
            cands["shuf+lzma"] = _lzma_c(sh)
        if bits.dtype.itemsize == 1 and bits.ndim >= 2 and bits.shape[0] > 1:
            t = np.ascontiguousarray(np.moveaxis(bits, 0, -1)).tobytes()
            cands["T+lzma"] = _lzma_c(t)
    enc = min(cands, key=lambda k: len(cands[k]))
    blob = cands[enc]
    return {"dtype": dtype, "shape": [int(s) for s in bits.shape],
            "enc": enc, "n": len(blob)}, blob


def _decode_leaf(spec: dict[str, Any], blob: bytes) -> np.ndarray:
    """-> numpy array of the stored bits (uint16 for bfloat16 leaves)."""
    store_dt = np.dtype(np.uint16 if spec["dtype"] == "bfloat16"
                        else spec["dtype"])
    shape = tuple(spec["shape"])
    enc = spec["enc"]
    if enc == "raw":
        b = blob
    elif enc == "zlib":
        b = zlib.decompress(blob)
    elif enc == "lzma":
        b = _lzma_d(blob)
    elif enc == "shuf+zlib":
        b = _byte_unshuffle(zlib.decompress(blob), store_dt.itemsize)
    elif enc == "shuf+lzma":
        b = _byte_unshuffle(_lzma_d(blob), store_dt.itemsize)
    elif enc == "T+lzma":
        t = np.frombuffer(_lzma_d(blob), store_dt)
        t = t.reshape(shape[1:] + shape[:1])
        return np.ascontiguousarray(np.moveaxis(t, -1, 0))
    else:
        raise ValueError(f"unknown leaf coding {enc!r} — payload written "
                         "by a newer build?")
    return np.frombuffer(b, store_dt).reshape(shape)


def _write_inra(path: str, payload: dict[str, Any]) -> None:
    leaves = tree_leaves(payload["params"])
    entries, blobs = [], []
    for name, arr in ([("scales", payload["scales"])]
                      + [(f"leaf_{i:05d}", l) for i, l in enumerate(leaves)]):
        spec, blob = _encode_leaf(arr)
        spec["name"] = name
        entries.append(spec)
        blobs.append(blob)
    header = json.dumps({"meta": payload["meta"], "entries": entries,
                         "nleaves": len(leaves)}).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_INRA_MAGIC)
        f.write(len(header).to_bytes(4, "little"))
        f.write(header)
        for blob in blobs:
            f.write(blob)


def _read_inra_header(f) -> dict[str, Any]:
    if f.read(len(_INRA_MAGIC)) != _INRA_MAGIC:
        raise ValueError(f"{f.name}: not an INRA payload")
    hlen = int.from_bytes(f.read(4), "little")
    return json.loads(f.read(hlen).decode("utf-8"))


def _read_inra(path: str):
    """-> (meta, scales, [(bits, dtype name)] per leaf)."""
    with open(path, "rb") as f:
        header = _read_inra_header(f)
        arrays = {spec["name"]: (_decode_leaf(spec, f.read(spec["n"])),
                                 spec["dtype"])
                  for spec in header["entries"]}
    leaves = [arrays[f"leaf_{i:05d}"] for i in range(header["nleaves"])]
    return header["meta"], arrays["scales"][0], leaves


def save_inr(path: str, payload: dict[str, Any]) -> str:
    """Write the payload as one file; returns the path.  INRA by default
    (``.inra`` appended when missing); a path ending in ``.npz`` selects the
    legacy npz container."""
    if path.endswith(".npz"):
        np.savez_compressed(path, **_flatten_payload(payload))
        return path
    if not path.endswith(".inra"):
        path = path + ".inra"
    _write_inra(path, payload)
    return path


def _resolve_payload_path(path: str) -> str:
    """Accept the path given to ``save_inr`` even if it appended .inra."""
    if not os.path.exists(path) and os.path.exists(path + ".inra"):
        return path + ".inra"
    return path


def _is_inra(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(len(_INRA_MAGIC)) == _INRA_MAGIC


def load_inr(path: str) -> dict[str, Any]:
    """Read a payload written by either package's ``save_inr`` (INRA or
    legacy npz, told apart by magic bytes).  The parameter tree is rebuilt
    from the stored model config and quantization header."""
    path = _resolve_payload_path(path)
    if _is_inra(path):
        meta, scales, stored = _read_inra(path)
    else:
        with np.load(path, allow_pickle=False) as f:
            meta = json.loads(bytes(f["__meta__"]).decode("utf-8"))
            scales = f["scales"]
            stored = [(f[f"leaf_{i:05d}"], None)
                      for i in range(int(f["__nleaves__"]))]
    _check_format(meta)
    template = _params_template(meta)
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(stored):
        raise ValueError("leaf count mismatch — corrupted payload")
    # npz stores bfloat16 as raw uint16 bits with no dtype record: the
    # template says which leaves they are
    leaves = [tensor_from_numpy(a, bfloat16_bits=(dt or tl) == "bfloat16")
              for tl, (a, dt) in zip(t_leaves, stored)]
    return {"meta": meta, "scales": np.asarray(scales),
            "params": tree_unflatten(template, leaves)}


def payload_info(path: str) -> dict[str, Any]:
    """Inspect a saved payload without decoding audio: container, header,
    per-leaf storage table and on-disk totals."""
    import zipfile

    path = _resolve_payload_path(path)
    entries: list[dict[str, Any]] = []
    if _is_inra(path):
        with open(path, "rb") as f:
            header = _read_inra_header(f)
        meta = header["meta"]
        for spec in header["entries"]:
            dt = np.dtype(np.uint16 if spec["dtype"] == "bfloat16"
                          else spec["dtype"])
            raw = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
            entries.append({"name": spec["name"], "dtype": spec["dtype"],
                            "shape": list(spec["shape"]), "enc": spec["enc"],
                            "stored_bytes": int(spec["n"]),
                            "raw_bytes": raw})
        container = "inra"
    else:
        with zipfile.ZipFile(path) as zf:
            sizes = {i.filename: i.compress_size for i in zf.infolist()}
        with np.load(path, allow_pickle=False) as f:
            meta = json.loads(bytes(f["__meta__"]).decode("utf-8"))
            for name in f.files:
                if name.startswith("__"):
                    continue
                a = f[name]
                entries.append({
                    "name": name, "dtype": a.dtype.name,
                    "shape": list(a.shape), "enc": "zip-deflate",
                    "stored_bytes": int(sizes.get(name + ".npy", a.nbytes)),
                    "raw_bytes": int(a.nbytes)})
        container = "npz"
    file_bytes = os.path.getsize(path)
    n = int(meta["signal_length"]) * int(meta.get("num_channels", 1))
    return {"container": container,
            "file_bytes": int(file_bytes),
            "bits_per_sample": 8.0 * file_bytes / n,
            "ratio_vs_pcm16": (2 * n) / file_bytes,
            "meta": meta,
            "leaves": entries,
            "stored_leaf_bytes": int(sum(e["stored_bytes"] for e in entries)),
            "raw_leaf_bytes": int(sum(e["raw_bytes"] for e in entries))}
