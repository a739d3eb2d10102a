"""Multi-INR windows: chunking, per-window evaluation and the crossfade
stitch (port of the decode half of ``inraudio_tpu/train/multi_inr.py``).

Every window shares one coordinate grid, so a window population is
evaluated as one stacked call (``INRModel.apply_stacked``, the stack
kernel on a card) and overlap-added on the host in float64, exactly as the
JAX package does.  The fitting half is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..models import INRModel
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class MultiINRConfig:
    chunk_seconds: float = 1.0
    overlap_fraction: float = 0.25  # of the chunk length, each side

    def __post_init__(self):
        # >0.5 would make the fade-out ramp overwrite part of the fade-in
        if not 0.0 <= self.overlap_fraction <= 0.5:
            raise ValueError(
                f"overlap_fraction must be in [0, 0.5], got "
                f"{self.overlap_fraction}")


def chunk_signal(signal: np.ndarray, sample_rate: int,
                 cfg: MultiINRConfig) -> tuple[np.ndarray, int, int]:
    """Slice into overlapping windows -> (chunks (k, n), chunk_length, hop).
    The tail is zero-padded to a full window."""
    n = int(round(cfg.chunk_seconds * sample_rate))
    overlap = int(round(cfg.overlap_fraction * n))
    hop = max(n - overlap, 1)
    length = len(signal)
    k = max(1, int(np.ceil(max(length - n, 0) / hop)) + 1)
    padded = np.zeros(((k - 1) * hop + n,), dtype=np.float32)
    padded[:length] = signal
    idx = (np.arange(k)[:, None] * hop) + np.arange(n)[None, :]
    return padded[idx], n, hop


def _crossfade_window(n: int, overlap: int) -> np.ndarray:
    """Linear fade-in/out ramps over the overlapped regions; interior flat.
    Normalised at stitch time by the accumulated weight."""
    w = np.ones(n, dtype=np.float32)
    if overlap > 0:
        ramp = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1]
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def stitch_chunks(outs: np.ndarray, hop: int, length: int) -> np.ndarray:
    """Crossfade overlap-add of (k, n) window decodes -> (length,)."""
    k, n = outs.shape
    w = _crossfade_window(n, n - hop)
    total = (k - 1) * hop + n
    acc = np.zeros(total, dtype=np.float64)
    den = np.zeros(total, dtype=np.float64)
    for i in range(k):
        acc[i * hop: i * hop + n] += outs[i] * w
        den[i * hop: i * hop + n] += w
    return (acc / np.maximum(den, 1e-12)).astype(np.float32)[:length]


def chunk_eval_fn(model: INRModel, coords: torch.Tensor,
                  fit_snr_db: float | None = None
                  ) -> Callable[[Any], torch.Tensor]:
    """Per-window dense eval over STACKED params -> (k, n, 1).

    ``fit_snr_db`` selects the quality-gated decode tier
    (``decode_apply_stacked``) as the codec's decode does; None evaluates
    through the untiered apply.  The kernel takes any window count and row
    count, so unlike the TPU kernels there is no shape gate."""
    if fit_snr_db is not None and model.decode_apply_stacked is not None:
        return lambda P: model.decode_apply_stacked(P, coords, fit_snr_db)
    if model.apply_stacked is not None:
        return lambda P: model.apply_stacked(P, coords)
    return lambda P: model.apply(P, coords)


def batched_chunk_eval(fn: Callable[[Any], torch.Tensor], params: Any, k: int,
                       max_chunks_per_batch: int | None) -> np.ndarray:
    """Evaluate ``fn`` over stacked params in batches of at most
    ``max_chunks_per_batch`` windows (None: one shot) -> host (k, n, 1).
    Eager PyTorch compiles nothing, so the last batch is not padded."""
    kb = max_chunks_per_batch
    if not kb or k <= kb:
        return fn(params).cpu().numpy()
    pieces = [fn(tree_map(lambda x: x[s:s + kb], params)).cpu().numpy()
              for s in range(0, k, kb)]
    return np.concatenate(pieces, axis=0)


def decode_chunk_range(fn: Callable[[Any], torch.Tensor], params: Any,
                       scales: np.ndarray, n: int, hop: int, k: int,
                       signal_length: int, start: int, stop: int,
                       max_chunks_per_batch: int | None = None) -> np.ndarray:
    """Random-access decode of samples ``[start, stop)``: evaluate only the
    windows that overlap the range and stitch them locally.  The covering
    set and the overlap-add order are those of the full decode, so with a
    forward whose per-window result does not depend on the batch (the stack
    kernel) the output equals the full decode's slice exactly."""
    start = int(max(0, min(start, signal_length)))
    stop = int(max(start, min(stop, signal_length)))
    if stop == start:
        return np.zeros((0,), np.float32)
    # smallest i with i*hop + n > start; largest i with i*hop < stop
    i_lo = max(0, (start - n) // hop + 1)
    i_hi = min(k - 1, (stop - 1) // hop)
    ksel = i_hi - i_lo + 1
    sel = tree_map(lambda x: x[i_lo:i_hi + 1], params)
    outs = batched_chunk_eval(fn, sel, ksel, max_chunks_per_batch)
    outs = outs[:ksel, :, 0] * scales[i_lo:i_hi + 1, None]
    local = stitch_chunks(outs, hop, stop - i_lo * hop)
    return local[start - i_lo * hop:]
