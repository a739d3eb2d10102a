"""Host-side wav I/O (port of ``inraudio_tpu/data/audio_io.py``)."""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile as wavfile


def read_wav(path: str, channel: int | None = None) -> tuple[int, np.ndarray]:
    """Read a wav file -> (sample_rate, float32 data).  ``channel`` selects
    one channel of a multichannel file; integer PCM keeps its raw scale."""
    sample_rate, data = wavfile.read(path)
    if data.ndim > 1 and channel is not None:
        data = data[:, channel]
    return sample_rate, data.astype(np.float32)


def write_wav(path: str, sample_rate: int, data: np.ndarray) -> None:
    wavfile.write(path, sample_rate, np.asarray(data, dtype=np.float32))
