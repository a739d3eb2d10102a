"""Evaluation metrics and the per-experiment summary record (port of
``inraudio_tpu/eval/metrics.py``): the reconstruction SNR, the
scale-invariant SNR, the log-spectral distance, ``experiment_record`` and
``save_parameters``.  ``parameters.json`` keeps the reference's schema,
including its 'total_trainig_time(min)' spelling."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..dsp.snr import calculate_snr
from ..dsp.stft import stft_real_imag
from ..models import param_bytes, param_count


def reconstruction_snr(reference: np.ndarray, reconstruction: np.ndarray,
                       trim: int = 0) -> float:
    """SNR (dB) over the shorter length; ``trim`` drops edge samples."""
    n = min(len(reference), len(reconstruction))
    a, b = reference[:n], reconstruction[:n]
    if trim > 0:
        a, b = a[trim:-trim], b[trim:-trim]
    return float(calculate_snr(a, b))


def si_snr(reference, estimate, eps: float = 1e-12) -> float:
    """Scale-invariant SNR (dB): the estimate's projection onto the
    reference against the residual, both mean-removed; a global gain on
    the estimate does not change it."""
    s = torch.as_tensor(np.asarray(reference), dtype=torch.float32).reshape(-1)
    x = torch.as_tensor(np.asarray(estimate), dtype=torch.float32).reshape(-1)
    s = s - torch.mean(s)
    x = x - torch.mean(x)
    target = (torch.dot(x, s) / (torch.dot(s, s) + eps)) * s
    noise = x - target
    return float(10.0 * torch.log10((torch.sum(target ** 2) + eps)
                                    / (torch.sum(noise ** 2) + eps)))


def log_spectral_distance(reference, estimate, n_fft: int = 1024,
                          hop: int | None = None,
                          rel_floor: float = 1e-10) -> float:
    """Log-spectral distance (dB, lower is better): the RMS over frames of
    each frame's RMS difference of log power spectra, both floored at
    ``rel_floor`` below the larger peak."""
    n = min(len(reference), len(estimate))
    a = torch.as_tensor(np.asarray(reference[:n]), dtype=torch.float32)
    b = torch.as_tensor(np.asarray(estimate[:n]), dtype=torch.float32)

    def power(x):
        re, im = stft_real_imag(x, n_fft=n_fft, hop=hop)
        return re * re + im * im

    pa_, pb_ = power(a), power(b)
    floor = torch.maximum(torch.max(pa_), torch.max(pb_)) * rel_floor + 1e-30
    pa = torch.log10(torch.maximum(pa_, floor))
    pb = torch.log10(torch.maximum(pb_, floor))
    per_frame = torch.sqrt(torch.mean((10.0 * (pa - pb)) ** 2, dim=0))
    return float(torch.sqrt(torch.mean(per_frame ** 2)))


def save_parameters(path: str, params: dict[str, Any]) -> str:
    """Write ``<path>/parameters.json``."""
    out = os.path.join(path, "parameters.json")
    with open(out, "w") as f:
        json.dump(params, f, indent=4, default=float)
    return out


def experiment_record(hparams: dict[str, Any], model_params,
                      train_time_s: float, snr: float) -> dict[str, Any]:
    """Hyperparameters + parameter sizes + training time + SNR."""
    rec = dict(hparams)
    rec["parameter_size(KB)"] = param_count(model_params) * 4 / 1024.0
    rec["total_model_size(KB)"] = param_bytes(model_params) / 1024.0
    rec["total_trainig_time(min)"] = train_time_s / 60.0
    rec["SNR"] = snr
    return rec
