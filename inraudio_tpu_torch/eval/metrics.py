"""Reconstruction SNR and the per-experiment summary record (port of
``inraudio_tpu/eval/metrics.py``'s ``reconstruction_snr``,
``experiment_record`` and ``save_parameters``).  ``parameters.json`` keeps
the reference's schema, including its 'total_trainig_time(min)' spelling."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ..dsp.snr import calculate_snr
from ..models import param_bytes, param_count


def reconstruction_snr(reference: np.ndarray, reconstruction: np.ndarray,
                       trim: int = 0) -> float:
    """SNR (dB) over the shorter length; ``trim`` drops edge samples."""
    n = min(len(reference), len(reconstruction))
    a, b = reference[:n], reconstruction[:n]
    if trim > 0:
        a, b = a[trim:-trim], b[trim:-trim]
    return float(calculate_snr(a, b))


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
