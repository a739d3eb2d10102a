"""Signal-to-noise ratio (port of ``inraudio_tpu/dsp/snr.py``):
10 log10(mean(orig^2) / mean((noisy - orig)^2))."""

from __future__ import annotations

import torch


def calculate_snr(original_signal, noisy_signal) -> torch.Tensor:
    """SNR in dB of ``noisy_signal`` against ``original_signal`` (tensors or
    arrays; computed in their dtype, float32 for float32 input)."""
    original_signal = torch.as_tensor(original_signal)
    noisy_signal = torch.as_tensor(noisy_signal)
    noise = noisy_signal - original_signal
    signal_power = torch.mean(torch.square(original_signal))
    noise_power = torch.mean(torch.square(noise))
    return 10.0 * torch.log10(signal_power / noise_power)
