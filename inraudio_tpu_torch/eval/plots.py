"""Artefact plots (port of ``inraudio_tpu/eval/plots.py``): spectrogram
PNGs, the waveform comparison, the loss / learning-rate history in dB and
the ``visualizer`` imshow of a coefficient matrix.  Host-side numpy and
matplotlib (Agg backend), imported only when a plot is drawn; without
matplotlib a plot raises ``ImportError`` (nothing is skipped silently)."""

from __future__ import annotations

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plots need matplotlib; run without plots "
                          "(make_plots=False, the fit CLI's --no-plots)"
                          ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plotspec(signal: np.ndarray, sample_rate: int, path: str,
             n_fft: int = 2048, noverlap: int = 512) -> None:
    """dB-magnitude spectrogram PNG of ``signal``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.specgram(np.asarray(signal), NFFT=n_fft, Fs=sample_rate,
                noverlap=noverlap, scale="dB")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("frequency (Hz)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def visualizer(matrix: np.ndarray, path: str, title: str = "STMDCT") -> None:
    """imshow PNG of a (freq, frames) coefficient or magnitude matrix."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(np.asarray(matrix), aspect="auto", origin="lower",
                   cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_loss_history(loss_history: np.ndarray, lr_history: np.ndarray,
                      path: str, title: str = "") -> None:
    """Loss and learning-rate curves in dB (10 log10) against the step."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(10.0 * np.log10(np.maximum(np.asarray(loss_history), 1e-30)),
            label="loss (dB)")
    ax.plot(10.0 * np.log10(np.maximum(np.asarray(lr_history), 1e-30)),
            label="lr (dB)")
    ax.set_xlabel("step")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_waveform_comparison(reference: np.ndarray,
                             reconstruction: np.ndarray, sample_rate: int,
                             path: str,
                             window: tuple[float, float] | None = None
                             ) -> None:
    """The reference and the reconstruction overlaid, over ``window``
    seconds or the common length."""
    plt = _pyplot()
    n = min(len(reference), len(reconstruction))
    t = np.arange(n) / sample_rate
    lo, hi = 0, n
    if window is not None:
        lo = int(window[0] * sample_rate)
        hi = min(int(window[1] * sample_rate), n)
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(t[lo:hi], reference[lo:hi], label="reference", alpha=0.7)
    ax.plot(t[lo:hi], reconstruction[lo:hi], label="reconstruction",
            alpha=0.7)
    ax.set_xlabel("time (s)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
