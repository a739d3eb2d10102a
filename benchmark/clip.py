"""The benchmark's input clip and its coordinate grid (frozen copies).

``synth_clip`` is the generator of ``chip_smoke.py``: three partials plus a
little noise, peak 0.8, with the noise drawn from the run's seed and the
length given.  ``wave_problem`` normalises it to peak 1 on a
``linspace(-1, 1, n)`` grid, as the runner's wave method does
(``data/fittings._wave_problem`` and ``data/coords.get_coord``).
"""

from __future__ import annotations

import numpy as np


def synth_clip(seed: int, n: int, fs: int) -> np.ndarray:
    """(n,) float32: 220, 1330 and 5100 Hz partials and 5% Gaussian noise
    from ``seed``, scaled to peak 0.8."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    sig = (np.sin(2 * np.pi * 220.0 * t) + 0.5 * np.sin(2 * np.pi * 1330.0 * t)
           + 0.25 * np.sin(2 * np.pi * 5100.0 * t)
           + 0.05 * rng.standard_normal(n))
    return (0.8 * sig / np.max(np.abs(sig))).astype(np.float32)


def wave_problem(clip: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(coords (n, 1) in [-1, 1], targets (n, 1) peak-normalised), float32."""
    coords = np.linspace(-1.0, 1.0, clip.shape[0], dtype=np.float32)
    peak = max(float(np.max(np.abs(clip))), 1e-9)
    return (coords.reshape(-1, 1),
            (clip / peak).astype(np.float32).reshape(-1, 1))
