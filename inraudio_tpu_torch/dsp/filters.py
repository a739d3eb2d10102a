"""Butterworth design and zero-phase filtering (port of
``inraudio_tpu/dsp/filters.py``).

The filters only set up a fitting target, once per fit, so the port designs
and filters on the host with scipy: ``lfilter`` / ``filtfilt`` run scipy's
direct-form-II-transposed recurrence (the JAX package's scan) in float64
and return the signal's dtype, with scipy's defaults for ``filtfilt`` (odd
extension, padlen 3 * max(len(a), len(b)), ``lfilter_zi`` initial
conditions).  The JAX package runs the recurrence in the signal's dtype: on
a float32 clip its order-5 highpass at 100 or 150 Hz diverges to NaN, a
fault of the reference this port does not copy.  A tensor goes in and comes
back on its device.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch


@functools.lru_cache(maxsize=None)
def butter_coeffs(order: int, cutoff: float, btype: str, fs: float):
    """Butterworth (b, a), float64."""
    b, a = scipy.signal.butter(order, cutoff, btype=btype, fs=fs)
    return np.asarray(b), np.asarray(a)


def _host(x):
    """(float64 numpy array, a function that puts a result where x was,
    in x's dtype)."""
    if isinstance(x, torch.Tensor):
        return (x.detach().cpu().numpy().astype(np.float64),
                lambda y: torch.from_numpy(np.ascontiguousarray(y)).to(
                    device=x.device, dtype=x.dtype))
    x = np.asarray(x)
    return x.astype(np.float64), lambda y: np.ascontiguousarray(y, x.dtype)


def lfilter(b, a, x, zi=None):
    """Causal IIR filter along a 1-D signal, computed in float64: y, or
    (y, zf) when ``zi`` is given."""
    xh, back = _host(x)
    if zi is None:
        return back(scipy.signal.lfilter(b, a, xh))
    y, zf = scipy.signal.lfilter(b, a, xh, zi=_host(zi)[0])
    return back(y), back(zf)


def filtfilt(b, a, x):
    """Zero-phase forward-backward filtering with scipy's defaults."""
    xh, back = _host(x)
    b, a = np.asarray(b), np.asarray(a)
    padlen = 3 * max(len(a), len(b))
    if xh.shape[0] <= padlen:
        raise ValueError(f"signal length {xh.shape[0]} must exceed padlen "
                         f"{padlen}")
    zi = scipy.signal.lfilter_zi(b, a)
    ext = np.concatenate([2.0 * xh[0] - xh[1:padlen + 1][::-1], xh,
                          2.0 * xh[-1] - xh[-(padlen + 1):-1][::-1]])
    y, _ = scipy.signal.lfilter(b, a, ext, zi=zi * ext[0])
    y = y[::-1]
    y, _ = scipy.signal.lfilter(b, a, y, zi=zi * y[0])
    return back(y[::-1][padlen:-padlen])


def hpfilter(data, cutoff: float, fs: float):
    """Order-5 Butterworth highpass, zero phase."""
    b, a = butter_coeffs(5, cutoff, "highpass", fs)
    return filtfilt(b, a, data)


def lpfilter(data, cutoff: float, fs: float):
    """Order-5 Butterworth lowpass, zero phase."""
    b, a = butter_coeffs(5, cutoff, "lowpass", fs)
    return filtfilt(b, a, data)
