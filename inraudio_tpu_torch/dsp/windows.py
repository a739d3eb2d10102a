"""Analysis / synthesis windows (port of ``inraudio_tpu/dsp/windows.py``;
host numpy in float64, identical values).

Each function returns the window itself (length ``n``).  The KBD window is
the one on the MDCT path and meets the Princen-Bradley condition
``w[k]^2 + w[k + n/2]^2 == 1`` that 50% overlap-add needs for perfect
reconstruction.  The long / short / start / stop quartet is the block
switching of ``dsp.adaptive``.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.special import i0


@functools.lru_cache(maxsize=None)
def sine_window(n: int) -> np.ndarray:
    """sin(pi (k + 0.5) / n)."""
    k = np.arange(n)
    return np.sin(np.pi * (k + 0.5) / n)


@functools.lru_cache(maxsize=None)
def hann_window(n: int) -> np.ndarray:
    """Hann with the half-sample offset."""
    k = np.arange(n)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * (k + 0.5) / n))


@functools.lru_cache(maxsize=None)
def hann_window_periodic(n: int) -> np.ndarray:
    """Periodic Hann without the offset (``torch.hann_window``), float32:
    the window of the STFT loss and the FFT-magnitude target."""
    k = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel-derived window: the square root of the running sum of
    a Kaiser window of length n/2 + 1 over its total, mirrored."""
    half = n // 2
    m = np.arange(half + 1)
    kaiser = i0(np.pi * alpha * np.sqrt(
        1.0 - ((2.0 * m + 1.0) / (n / 2 + 1.0) - 1.0) ** 2)) / i0(
        np.pi * alpha)
    total = kaiser.sum()
    left = np.sqrt(np.cumsum(kaiser[:half]) / total)
    return np.concatenate([left, left[::-1]])


@functools.lru_cache(maxsize=None)
def rect_window(n: int) -> np.ndarray:
    """Rectangular window scaled by 0.2."""
    return 0.2 * np.ones(n)


@functools.lru_cache(maxsize=None)
def long_window(n_long: int = 1024, alpha: float = 4.0) -> np.ndarray:
    """Long block: KBD of length ``n_long``."""
    return kbd_window(n_long, alpha)


@functools.lru_cache(maxsize=None)
def short_window(n_short: int = 256) -> np.ndarray:
    """Short block: sine of length ``n_short``."""
    return sine_window(n_short)


@functools.lru_cache(maxsize=None)
def transition_start_window(n_long: int = 1024, n_short: int = 256,
                            alpha: float = 4.0) -> np.ndarray:
    """Long to short, length (n_long + n_short) / 2: the long KBD's rising
    half, then the short sine's falling half."""
    left = kbd_window(n_long, alpha)[: n_long // 2]
    right = sine_window(n_short)[n_short // 2:]
    return np.concatenate([left, right])


@functools.lru_cache(maxsize=None)
def transition_stop_window(n_long: int = 1024, n_short: int = 256,
                           alpha: float = 4.0) -> np.ndarray:
    """Short to long: the short sine's rising half, then the long KBD's
    falling half."""
    left = sine_window(n_short)[: n_short // 2]
    right = kbd_window(n_long, alpha)[n_long // 2:]
    return np.concatenate([left, right])
