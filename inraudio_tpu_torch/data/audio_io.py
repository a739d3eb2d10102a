"""Host-side wav I/O and decimation (port of
``inraudio_tpu/data/audio_io.py``)."""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile as wavfile
import scipy.signal


def read_wav(path: str, channel: int | None = None) -> tuple[int, np.ndarray]:
    """Read a wav file -> (sample_rate, float32 data).  ``channel`` selects
    one channel of a multichannel file; integer PCM keeps its raw scale."""
    sample_rate, data = wavfile.read(path)
    if data.ndim > 1 and channel is not None:
        data = data[:, channel]
    return sample_rate, data.astype(np.float32)


def write_wav(path: str, sample_rate: int, data: np.ndarray) -> None:
    wavfile.write(path, sample_rate, np.asarray(data, dtype=np.float32))


def decimate(data: np.ndarray, q: int, ftype: str = "iir",
             zero_phase: bool = True) -> np.ndarray:
    """Anti-aliased downsampling by an integer factor: scipy's decimate
    (order-8 Chebyshev-I, zero phase), as float32."""
    if q <= 1:
        return data
    return scipy.signal.decimate(data, q=int(q), ftype=ftype,
                                 zero_phase=zero_phase).astype(np.float32)
