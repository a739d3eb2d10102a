"""Composite experiments (port of ``inraudio_tpu/experiments/pipelines.py``):

- ``procedural_train``: the decimation curriculum, d8 -> d4 -> d2 -> d1,
  each phase a ``train`` warm-started (model and optimizer) from the
  previous phase's checkpoint;
- ``band_split_train``: the signal split at a cutoff by ``dsp.filters``'
  ``lpfilter`` / ``hpfilter`` (order-5 Butterworth low- and high-pass,
  zero phase, the recurrence run in float64 on the host, where the JAX
  package runs it in the signal's float32), each band fitted by its own
  ``train_from_signal``, the reconstructions summed.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..dsp.filters import hpfilter, lpfilter
from ..eval.metrics import reconstruction_snr
from .runner import train, train_from_signal


def procedural_train(experiment_path: str, tag: str,
                     decimations=(8, 4, 2, 1), **train_kwargs) -> str | None:
    """``train`` over a decimation curriculum, ``<tag>_d<d>`` a phase; each
    phase starts from the previous one's checkpoint.  Returns the last
    checkpoint path (None on ranks other than 0 of a mesh)."""
    prev = train_kwargs.pop("prev_ckpt_path", None)
    for d in decimations:
        prev = train(experiment_path, f"{tag}_d{d}", decimation=d,
                     prev_ckpt_path=prev, **train_kwargs)
    return prev


def band_split_train(experiment_path: str, tag: str,
                     input_signal: np.ndarray, input_fs: int,
                     cutoff: float = 10000.0,
                     lp_kwargs: dict[str, Any] | None = None,
                     hp_kwargs: dict[str, Any] | None = None,
                     **common_kwargs) -> dict[str, Any]:
    """Split at ``cutoff`` Hz, fit the low band (``<tag>_lp``) and the high
    band (``<tag>_hp``) each with its own model, and sum the two
    reconstructions.  ``lp_kwargs`` / ``hp_kwargs`` override
    ``common_kwargs`` per band.  Returns {"lp", "hp": each band's
    ``train_from_signal`` result, "rec": the sum, "snr": its SNR against
    the input}."""
    sig = np.asarray(input_signal, dtype=np.float32)
    low = np.asarray(lpfilter(sig, cutoff, input_fs), dtype=np.float32)
    high = np.asarray(hpfilter(sig, cutoff, input_fs), dtype=np.float32)
    out_lp = train_from_signal(experiment_path, f"{tag}_lp", low, input_fs,
                               **{**common_kwargs, **(lp_kwargs or {})})
    out_hp = train_from_signal(experiment_path, f"{tag}_hp", high, input_fs,
                               **{**common_kwargs, **(hp_kwargs or {})})
    n = min(len(out_lp["rec"]), len(out_hp["rec"]))
    combined = out_lp["rec"][:n] + out_hp["rec"][:n]
    snr = reconstruction_snr(sig[:n], combined)
    return {"lp": out_lp, "hp": out_hp, "rec": combined, "snr": snr}
