"""The benchmark's input clip, its coordinate grid and its window
population (frozen copies).

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


def window_problem(clip: np.ndarray, fs: int, chunk_seconds: float,
                   overlap_fraction: float
                   ) -> tuple[np.ndarray, np.ndarray, int]:
    """The codec's window population of a clip, as ``multi_inr_fit`` cuts
    it (``train/multi_inr.chunk_signal``): windows of n = round(chunk_seconds
    fs) samples every hop = n - round(overlap_fraction n), the tail
    zero-padded to a whole window, each peak-normalised.  Returns (coords
    (n, 1) on ``linspace(-1, 1, n)``, targets (k, n, 1), hop), float32."""
    n = int(round(chunk_seconds * fs))
    hop = max(n - int(round(overlap_fraction * n)), 1)
    k = max(1, int(np.ceil(max(clip.shape[0] - n, 0) / hop)) + 1)
    padded = np.zeros(((k - 1) * hop + n,), dtype=np.float32)
    padded[:clip.shape[0]] = clip
    chunks = padded[np.arange(k)[:, None] * hop + np.arange(n)[None, :]]
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    coords = np.linspace(-1.0, 1.0, n, dtype=np.float32).reshape(-1, 1)
    return (coords, (chunks / scales[:, None])[..., None].astype(np.float32),
            hop)
