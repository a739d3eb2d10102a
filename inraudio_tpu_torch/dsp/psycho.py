"""Psychoacoustic helpers (port of ``inraudio_tpu/dsp/psycho.py``): the
threshold in quiet, SPL to intensity, and the hearing-threshold weight of
the mdct target's loss (``data.fittings.mdct_fitting(perceptual_mask=
True)``)."""

from __future__ import annotations

import numpy as np
import torch


def thresh_quiet(f) -> torch.Tensor:
    """Threshold in quiet (SPL dB) at frequency f in Hz, float32, on f's
    device (f clipped below at 20 Hz)."""
    f = torch.clamp(torch.as_tensor(f, dtype=torch.float32), min=20.0)
    khz = f / 1000.0
    return (3.64 * khz ** (-0.8) - 6.5 * torch.exp(-0.6 * (khz - 3.3) ** 2)
            + 1e-3 * khz ** 4)


def intensity(spl) -> torch.Tensor:
    """SPL -> intensity, the /20 variant used for MDCT magnitudes."""
    return 10.0 ** ((torch.as_tensor(spl) - 96.0) / 20.0)


def hearing_threshold_mask(n: int, sample_rate: float,
                           num_frames: int) -> np.ndarray:
    """Per-coefficient loss weight of an (n // 2, num_frames) STMDCT:
    each bin's threshold in quiet, its minimum subtracted, clipped at 10
    dB, mapped to [0.8, 1.0] (bins with a low threshold get full weight).
    Returns float32 (n // 2 * num_frames, 1), aligned with the flattened
    targets."""
    half = n // 2
    freqs = np.arange(half) * sample_rate / 2.0 / (half - 1) + 1.0
    threshold = thresh_quiet(freqs).numpy()
    threshold = threshold - threshold.min()
    threshold = np.clip(threshold, None, 10.0)
    reduction = (100.0 - threshold) / 100.0 * 0.2 + 0.8
    mask = np.tile(reduction[:, None], (1, num_frames))
    return mask.reshape(-1, 1).astype(np.float32)
