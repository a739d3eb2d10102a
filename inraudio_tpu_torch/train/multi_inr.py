"""Chunked multi-INR fitting and decode: one small INR per overlapping
window of a clip, all windows trained at once (port of
``inraudio_tpu/train/multi_inr.py``).

Every window shares one coordinate grid, so the population is one stacked
state with a leading window axis: ``_fit_chunk_population`` runs the
whole-step kernel D (``ops.siren_step``) or the autograd step with kernel
C's backward over all windows per step, in rounds of ``scan_chunk`` steps
that read nothing back from the device.  On a mesh of more than one rank
(``parallel.make_mesh``) the windows are sharded: the population is padded
to a multiple of the ranks, each rank trains its own windows with no
collective inside a round, and one all-gather at the end leaves the whole
result on every rank.  A window's arithmetic does not depend on which
windows share its launch, so its history is the same on any number of
ranks.  Decoding evaluates the population
as one stacked call (``INRModel.apply_stacked``, the stack kernel on a
card) and overlap-adds on the host in float64, exactly as the JAX package
does.  Each window is peak-normalised; its scale restores the amplitude at
stitch time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..data.coords import get_coord
from ..models import INRModel
from ..parallel.mesh import Mesh, pad_to_multiple, resolve_mesh
from ..tree import tree_map
from .loop import (TrainConfig, TrainState, fused_step_plan,
                   init_train_state, make_train_step,
                   make_vmapped_fused_step)


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


class MultiINRResult(NamedTuple):
    states: TrainState        # stacked on the window axis, on the fit device
    chunk_scales: np.ndarray  # (k,) per-window peak de-normalisation
    chunk_length: int
    hop: int
    num_chunks: int
    signal_length: int
    loss_history: np.ndarray  # (steps, k)
    train_time_s: float


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


def multi_inr_fit(model: INRModel, signal: np.ndarray, sample_rate: int,
                  cfg: MultiINRConfig | None = None,
                  train_cfg: TrainConfig | None = None, seed: int = 0,
                  device: torch.device | str | None = None,
                  max_chunks_per_batch: int | None = None,
                  mesh: Mesh | None = None, metrics=None) -> MultiINRResult:
    """Fit one INR per window, all windows at once on ``device`` (default
    the card; without one it raises, pass "cpu" for the CPU).  ``metrics``
    (a ``utils.observability.MetricsLogger``) takes one record a round, read
    from the round's last step: on a mesh the ranks gather it, so every rank
    passes a logger or none does.  The
    initial parameters are drawn from ``torch.Generator().manual_seed(
    seed)`` (the JAX package's PRNG key; the numbers differ, the
    distributions match).  ``max_chunks_per_batch`` trains the population
    in batches of that many windows, with finished states moved to the
    host, to bound device memory for long clips.  ``mesh``
    (``parallel.make_mesh(device)`` when None) shards the windows over its
    ranks; the fit runs on ``mesh.device`` (a ``device`` given beside a
    mesh must be that one)."""
    cfg = cfg or MultiINRConfig()
    train_cfg = train_cfg or TrainConfig()
    mesh = resolve_mesh(mesh, device)
    chunks, n, hop = chunk_signal(np.asarray(signal, dtype=np.float32),
                                  sample_rate, cfg)
    return _fit_chunks(model, chunks, n, hop, len(signal), train_cfg,
                       torch.Generator().manual_seed(seed), mesh,
                       max_chunks_per_batch, metrics)


def _fit_chunks(model, chunks, n, hop, signal_length, train_cfg, generator,
                mesh, max_chunks_per_batch, metrics=None) -> MultiINRResult:
    """Train a (k, n) window population, optionally in batches (the
    ``max_chunks_per_batch`` memory bound).  Eager PyTorch compiles
    nothing, so the last batch is not padded."""
    k = chunks.shape[0]
    kb = max_chunks_per_batch
    if not kb or k <= kb:
        return _fit_chunk_population(model, chunks, n, hop, signal_length,
                                     train_cfg, generator, mesh, metrics)
    parts = []
    for start in range(0, k, kb):
        r = _fit_chunk_population(model, chunks[start:start + kb], n, hop,
                                  signal_length, train_cfg, generator, mesh,
                                  metrics)
        # finished states to the host before the next batch trains
        parts.append(r._replace(states=tree_map(lambda x: x.cpu(),
                                                r.states)))
    states = tree_map(lambda *xs: torch.cat(xs), *[p.states for p in parts])
    return MultiINRResult(
        states=states,
        chunk_scales=np.concatenate([p.chunk_scales for p in parts]),
        chunk_length=n, hop=hop, num_chunks=k, signal_length=signal_length,
        loss_history=np.concatenate([p.loss_history for p in parts], axis=1),
        train_time_s=sum(p.train_time_s for p in parts))


def multi_inr_fit_many(model: INRModel, signals: list[np.ndarray],
                       sample_rate: int, cfg: MultiINRConfig | None = None,
                       train_cfg: TrainConfig | None = None, seed: int = 0,
                       device: torch.device | str | None = None,
                       max_chunks_per_batch: int | None = None,
                       mesh: Mesh | None = None) -> list[MultiINRResult]:
    """Fit several clips as one population: each clip is chunked on its
    own (windows stay aligned to clip starts), the populations are
    concatenated and trained together, and the result is split back into
    one ``MultiINRResult`` per clip.  ``device`` and ``mesh`` as
    ``multi_inr_fit``."""
    cfg = cfg or MultiINRConfig()
    train_cfg = train_cfg or TrainConfig()
    mesh = resolve_mesh(mesh, device)
    if not signals:
        return []
    per_clip = [chunk_signal(np.asarray(s, dtype=np.float32), sample_rate,
                             cfg) for s in signals]
    n, hop = per_clip[0][1], per_clip[0][2]
    chunks = np.concatenate([c for c, _, _ in per_clip], axis=0)
    res = _fit_chunks(model, chunks, n, hop, chunks.shape[0] * n, train_cfg,
                      torch.Generator().manual_seed(seed), mesh,
                      max_chunks_per_batch)
    out, start = [], 0
    for (c, _, _), sig in zip(per_clip, signals):
        sl = slice(start, start + c.shape[0])
        out.append(MultiINRResult(
            states=tree_map(lambda x: x[sl], res.states),
            chunk_scales=res.chunk_scales[sl], chunk_length=n, hop=hop,
            num_chunks=c.shape[0],
            signal_length=len(np.asarray(sig).reshape(-1)),
            loss_history=res.loss_history[:, sl],
            train_time_s=res.train_time_s))
        start += c.shape[0]
    return out


def _fit_chunk_population(model, chunks, n, hop, signal_length, train_cfg,
                          generator, mesh: Mesh,
                          metrics=None) -> MultiINRResult:
    """Core of the fit: train a (k, n) window population on the mesh.

    A round of ``scan_chunk`` steps launches work and reads nothing back:
    the per-step losses stay a device tensor until the fit ends.  On more
    than one rank the population is padded to a multiple of the ranks
    (zero targets, window 0's initial state: the init of the real windows
    does not depend on the mesh) and each rank trains its own contiguous
    share; one all-gather ends the fit."""
    dev = mesh.device
    k = chunks.shape[0]
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-9)
    targets = (chunks / scales[:, None])[..., None].astype(np.float32)
    coords = torch.from_numpy(get_coord(n, dim=1)).to(dev)
    states = init_train_state(model, generator, train_cfg, dev, windows=k)
    if mesh.size > 1:
        targets, _ = pad_to_multiple(targets, mesh.size)
        kr = targets.shape[0] // mesh.size
        own = slice(mesh.rank * kr, (mesh.rank + 1) * kr)
        pad = targets.shape[0] - k
        states = tree_map(lambda x: torch.cat(
            [x, x[:1].expand(pad, *x.shape[1:])])[own].clone(), states)
        targets = targets[own]
    fused = fused_step_plan(model, train_cfg, n) is not None
    if fused:
        vstep, to_flat, from_flat, prep_targets = make_vmapped_fused_step(
            model, train_cfg, coords)
        targets_d = prep_targets(targets)
        states = to_flat(states)
    else:
        train_step = make_train_step(model, train_cfg)
        targets_d = torch.from_numpy(targets).to(dev)
        vstep = lambda s, t: train_step(s, coords, t)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    hists = []
    done = 0
    while done < train_cfg.total_steps:
        m = min(train_cfg.scan_chunk, train_cfg.total_steps - done)
        round_losses = []
        for _ in range(m):
            states, (loss, _lr) = vstep(states, targets_d)
            round_losses.append(loss)
        hists.append(torch.stack(round_losses))
        done += m
        if metrics is not None:
            # the round's one host read: its last step's window losses
            last = round_losses[-1]
            if mesh.size > 1:
                last = mesh.all_gather(last)
            last = last[:k].cpu().numpy()
            elapsed = time.time() - t0
            metrics.log({"event": "round", "step": done,
                         "loss": float(np.mean(last)),
                         "worst_chunk_loss": float(np.max(last)),
                         "elapsed_s": round(elapsed, 3),
                         "steps_per_sec": round(done / max(elapsed, 1e-9),
                                                2)})
    sync()
    train_time = mesh.span(t0, time.time())
    hist = torch.cat(hists) if hists else torch.zeros(
        (0, targets_d.shape[0]), device=dev)
    if mesh.size > 1:
        states = tree_map(lambda x: mesh.all_gather(x)[:k], states)
        hist = mesh.all_gather(hist.T).T[:, :k]
    if fused:
        states = from_flat(states)
    hist = hist.cpu().numpy()
    return MultiINRResult(states=states, chunk_scales=scales,
                          chunk_length=n, hop=hop, num_chunks=k,
                          signal_length=signal_length, loss_history=hist,
                          train_time_s=train_time)


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


def multi_inr_decode_range(model: INRModel, result: MultiINRResult,
                           start: int, stop: int, track_best: bool = True,
                           max_chunks_per_batch: int | None = None
                           ) -> np.ndarray:
    """Decode only samples ``[start, stop)`` of the fitted clip, on the
    device its states lie on (see ``decode_chunk_range``)."""
    params = _decode_params(result, track_best)
    fn = chunk_eval_fn(model, _grid_like(result, params))
    return decode_chunk_range(fn, params, result.chunk_scales,
                              result.chunk_length, result.hop,
                              result.num_chunks, result.signal_length, start,
                              stop, max_chunks_per_batch)


def multi_inr_decode(model: INRModel, result: MultiINRResult,
                     track_best: bool = True,
                     max_chunks_per_batch: int | None = None) -> np.ndarray:
    """Evaluate every window (one stacked call) on the device its states
    lie on and overlap-add -> the stitched waveform."""
    params = _decode_params(result, track_best)
    fn = chunk_eval_fn(model, _grid_like(result, params))
    outs = batched_chunk_eval(fn, params, result.num_chunks,
                              max_chunks_per_batch)
    outs = outs[:result.num_chunks, :, 0] * result.chunk_scales[:, None]
    return stitch_chunks(outs, result.hop, result.signal_length)


def _decode_params(result: MultiINRResult, track_best: bool):
    """The result's (best) params as contiguous tensors: a fused fit's
    states are views into its flat buffers, and the stack kernel takes
    contiguous leaves."""
    params = (result.states.best_params if track_best
              else result.states.params)
    return tree_map(torch.Tensor.contiguous, params)


def _grid_like(result: MultiINRResult, params) -> torch.Tensor:
    dev = params["layers"][0]["w"].device
    return torch.from_numpy(get_coord(result.chunk_length, dim=1)).to(dev)
