"""Fitting problems (port of ``inraudio_tpu/data/fittings.py``).

A ``FittingProblem`` is the full-batch coordinates and targets of one fit
as host numpy, plus what the decode needs to invert the normalisation (the
``decode`` contract: the JAX package's keys and values) and an optional
per-row loss weight.  Builders:

- ``waveform_fitting`` / ``waveform_fitting_from_array``: the time-domain
  target, peak-normalised;
- ``multi_waveform_fitting``: every channel on (time, channel) coordinates;
- ``fft_fitting``: the STFT magnitude on (freq, time) coordinates;
- ``mdct_fitting``: the STMDCT coefficients with the shift / log / mean /
  scale contract, the hearing-threshold loss weight, and the block-switching
  form (``adaptive``).

The transforms run on ``device`` (default the card; it raises without one,
and the CPU runs them only when asked) and come back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import torch

from ..device import resolve_device
from ..dsp.filters import hpfilter
from ..dsp.mdct import stmdct
from ..dsp.psycho import hearing_threshold_mask
from ..dsp.stft import stft_magnitude
from ..dsp.windows import hann_window_periodic
from .audio_io import decimate, read_wav
from .coords import get_coord, grid_coords_2d


@dataclasses.dataclass
class FittingProblem:
    """A complete INR fitting target: full-batch coords/targets + decode
    info (the JAX package's fields)."""

    coords: np.ndarray          # (n, d) float32
    targets: np.ndarray         # (n, 1) float32, the normalised target
    sample_rate: int            # rate of the (possibly decimated) target
    original_sample_rate: int   # rate of the source audio
    height: int                 # rows when reshaping the flat target
    width: int                  # cols when reshaping the flat target
    method: str                 # 'wave' | 'multi' | 'fft' | 'mdct'
    decode: dict[str, Any]      # inversion contract (see eval.decode)
    loss_weight: np.ndarray | None = None  # (n, 1) per-row loss weight

    @property
    def num_samples(self) -> int:
        return self.coords.shape[0]

    @property
    def in_features(self) -> int:
        return self.coords.shape[1]


def _wave_problem(data: np.ndarray, sample_rate: int,
                  original_sample_rate: int,
                  coord_scale: float) -> FittingProblem:
    # zero-peak guard (a silent clip): targets stay finite
    peak = max(float(np.max(np.abs(data))), 1e-9)
    return FittingProblem(
        coords=get_coord(len(data), dim=1, scale=coord_scale),
        targets=(data / peak).astype(np.float32).reshape(-1, 1),
        sample_rate=sample_rate, original_sample_rate=original_sample_rate,
        height=len(data), width=1, method="wave",
        decode={"kind": "wave", "peak": peak})


def waveform_fitting(filename: str, duration: float,
                     decimation: int = 1) -> FittingProblem:
    """Channel 0 of a wav file, cut to ``duration`` seconds, optionally
    decimated, peak-normalised to [-1, 1]; coords in [-1, 1]."""
    sample_rate, data = read_wav(filename, channel=0)
    data = data[: int(duration * sample_rate)]
    original_sample_rate = sample_rate
    if decimation > 1:
        data = decimate(data, int(decimation))
        sample_rate = sample_rate // int(decimation)
    return _wave_problem(data, sample_rate, original_sample_rate, 1.0)


def waveform_fitting_from_array(signal: np.ndarray, sample_rate: int,
                                decimation: int = 1,
                                coord_scale: float = 100.0
                                ) -> FittingProblem:
    """An in-memory signal; coords span [-coord_scale, coord_scale] and the
    peak is kept in the decode contract."""
    data = np.asarray(signal, dtype=np.float32)
    original_sample_rate = sample_rate
    if decimation > 1:
        data = decimate(data, int(decimation))
        sample_rate = sample_rate // int(decimation)
    return _wave_problem(data, sample_rate, original_sample_rate,
                         coord_scale)


def multi_waveform_fitting(filename: str, duration: float,
                           num_channels: int,
                           lp: bool = False) -> FittingProblem:
    """Every channel on 2-D coordinates (time in [-1, 1], channel in
    [-1, 1], or 0 for one channel), the targets all channels flattened.
    As in the JAX package, the amplitudes are not normalised."""
    sample_rate, data = read_wav(filename, channel=None)
    if data.ndim == 1:
        data = data[:, None]
    data = data[: int(duration * sample_rate), :num_channels]
    original_sample_rate = sample_rate
    if lp:
        data = np.column_stack([decimate(data[:, i], 2, ftype="fir")
                                for i in range(num_channels)])
        sample_rate = sample_rate // 2
    height, width = data.shape
    width_range = (0.0, 0.0) if num_channels == 1 else (-1.0, 1.0)
    return FittingProblem(
        coords=grid_coords_2d(height, width, width_range=width_range),
        targets=data.reshape(-1, 1).astype(np.float32),
        sample_rate=sample_rate, original_sample_rate=original_sample_rate,
        height=height, width=width, method="multi",
        decode={"kind": "wave", "peak": 1.0})


def hann_window_torch(n: int) -> np.ndarray:
    """``torch.hann_window`` (periodic, no offset): an alias of
    ``dsp.windows.hann_window_periodic``."""
    return hann_window_periodic(n)


def _spectral_source(filename: str, duration: float, highpass: bool,
                     cutoff: float) -> tuple[int, np.ndarray]:
    """Channel 1 of the file (the only one of a mono file), optionally
    highpassed at ``cutoff`` Hz, cut to ``duration``, peak-normalised."""
    sample_rate, data = read_wav(filename, channel=1)
    if highpass:
        data = np.asarray(hpfilter(data, cutoff, sample_rate))
    data = data[: int(duration * sample_rate)]
    return sample_rate, data / max(float(np.max(np.abs(data))), 1e-9)


def fft_fitting(filename: str, duration: float, n_fft: int = 1024,
                highpass: bool = False,
                device: torch.device | str = "cuda") -> FittingProblem:
    """The STFT magnitude (periodic Hann, hop n_fft // 4, centred) of the
    normalised clip (100 Hz highpass optional), divided by its maximum, on
    (freq, time) coordinates in [-1, 1]^2."""
    device = resolve_device(device)
    sample_rate, data = _spectral_source(filename, duration, highpass, 100.0)
    window = torch.as_tensor(hann_window_torch(n_fft), device=device)
    mag = stft_magnitude(
        torch.as_tensor(data, dtype=torch.float32, device=device),
        n_fft=n_fft, hop=n_fft // 4, window=window, center=True).cpu().numpy()
    scale = float(mag.max())
    mag = mag / scale
    height, width = mag.shape
    return FittingProblem(
        coords=grid_coords_2d(height, width),
        targets=mag.reshape(-1, 1).astype(np.float32),
        sample_rate=sample_rate, original_sample_rate=sample_rate,
        height=height, width=width, method="fft",
        decode={"kind": "fft", "scale": scale, "n_fft": n_fft,
                "length": int(len(data))})


def _normalise(coeffs: np.ndarray, takelog: bool):
    """(normalised float32 coeffs, shift, mean, scale): shift then log
    (takelog), minus the mean, over the largest magnitude.  The shift's
    1e-8 margin rounds away in float32 once |min| > ~0.13; the JAX package
    then takes log(0) = -inf and every target is NaN (a fault of the
    reference).  Here a sum that rounded to 0 or below takes the margin,
    1e-8; every other value is the JAX package's, bit for bit."""
    shift = 0.0
    if takelog:
        shift = float(np.abs(coeffs.min())) + 1e-8
        arg = coeffs + shift
        coeffs = np.log(np.where(arg > 0, arg, np.float32(1e-8)))
    mean = float(coeffs.mean())
    coeffs = coeffs - mean
    scale = float(np.max(np.abs(coeffs)))
    return coeffs / scale, shift, mean, scale


def mdct_fitting(filename: str, duration: float, n: int = 1024,
                 highpass: bool = False, takelog: bool = False,
                 perceptual_mask: bool = False, adaptive: bool = False,
                 n_short: int = 256, transient_threshold: float = 8.0,
                 device: torch.device | str = "cuda") -> FittingProblem:
    """The STMDCT coefficients (frame length n) of the normalised clip (150
    Hz highpass optional), optionally shift-then-log compressed, minus
    their mean, over their largest magnitude, on (freq, time) coordinates.
    The decode inverts ``out * scale + mean - shift``, then ``exp`` when
    ``takelog``.  ``perceptual_mask`` sets the hearing-threshold loss
    weight; ``adaptive`` the block-switching target
    (``_mdct_fitting_adaptive``)."""
    device = resolve_device(device)
    sample_rate, data = _spectral_source(filename, duration, highpass, 150.0)
    data = data.astype(np.float32)
    if adaptive:
        return _mdct_fitting_adaptive(data, sample_rate, n, n_short,
                                      transient_threshold, takelog, device)
    coeffs = stmdct(torch.as_tensor(data, device=device),
                    n=n).cpu().numpy().astype(np.float32)
    coeffs, shift, mean, scale = _normalise(coeffs, takelog)
    height, width = coeffs.shape
    weight = (hearing_threshold_mask(n, sample_rate, width)
              if perceptual_mask else None)
    return FittingProblem(
        coords=grid_coords_2d(height, width),
        targets=coeffs.reshape(-1, 1).astype(np.float32),
        sample_rate=sample_rate, original_sample_rate=sample_rate,
        height=height, width=width, method="mdct",
        decode={"kind": "mdct", "n": n, "takelog": takelog, "shift": shift,
                "mean": mean, "scale": scale},
        loss_weight=weight)


def _mdct_fitting_adaptive(data: np.ndarray, sample_rate: int, n_long: int,
                           n_short: int, threshold: float, takelog: bool,
                           device: torch.device) -> FittingProblem:
    """The block-switching target: transients detected, long / start /
    short / stop frames planned, each kind's bank transformed, and the
    banks flattened into one (n, 2) problem on physical coordinates
    (frequency (bin + 0.5) / bins and time frame centre / clip length, both
    in [-1, 1]), with the bank slices in the decode contract."""
    from ..dsp.adaptive import (KINDS, detect_transients, plan_blocks,
                                stmdct_adaptive)
    flags = detect_transients(data, n_long=n_long, n_short=n_short,
                              threshold=threshold)
    plan = plan_blocks(len(data), flags, n_long=n_long, n_short=n_short)
    banks = {k: v.cpu().numpy().astype(np.float32) for k, v in
             stmdct_adaptive(torch.as_tensor(data, device=device),
                             plan).items()}
    coords_blocks, target_blocks = [], []
    bank_slices: dict[str, tuple[int, int, int]] = {}
    pos = 0
    for kind in KINDS:
        if kind not in banks:
            continue
        c = banks[kind]                      # (num_frames, bins)
        num, bins = c.shape
        a, b = plan.halves(kind)
        centers = plan.starts(kind).astype(np.float64) + (a + b) / 2.0
        tt = centers / max(plan.num_samples, 1) * 2.0 - 1.0
        ff = (np.arange(bins, dtype=np.float64) + 0.5) / bins * 2.0 - 1.0
        coords_blocks.append(np.stack(
            [np.tile(ff, num), np.repeat(tt, bins)], axis=1))
        target_blocks.append(c.reshape(-1))
        bank_slices[kind] = (pos, num, bins)
        pos += num * bins
    coords = np.concatenate(coords_blocks).astype(np.float32)
    flat, shift, mean, scale = _normalise(
        np.concatenate(target_blocks).astype(np.float32), takelog)
    return FittingProblem(
        coords=coords, targets=flat.reshape(-1, 1),
        sample_rate=sample_rate, original_sample_rate=sample_rate,
        height=len(flat), width=1, method="mdct",
        decode={"kind": "mdct_adaptive", "n_long": n_long,
                "n_short": n_short, "takelog": takelog, "shift": shift,
                "mean": mean, "scale": scale,
                "plan_kinds": list(plan.kinds),
                "plan_offsets": list(plan.offsets),
                "num_samples": int(plan.num_samples),
                "bank_slices": {k: list(v) for k, v in bank_slices.items()}})
