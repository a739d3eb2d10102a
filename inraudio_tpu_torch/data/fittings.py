"""Fitting problems for the time-domain method (port of the wave builders
of ``inraudio_tpu/data/fittings.py``; host numpy, identical values).

A ``FittingProblem`` is the full-batch coordinates and targets of one fit
plus what the decode needs to invert the normalisation.  The mdct, fft and
multichannel builders are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .audio_io import decimate, read_wav
from .coords import get_coord


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
    method: str                 # 'wave' here
    decode: dict[str, Any]      # inversion contract (see eval.decode)
    loss_weight: np.ndarray | None = None

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
