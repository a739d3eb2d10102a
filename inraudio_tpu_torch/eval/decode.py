"""Dense decode of a fitted model (port of ``inraudio_tpu/eval/decode.py``):
evaluate the model over the coordinate grid in chunks on the device, then
invert the target's transform there.  wave and multi de-normalise by the
stored peak (bandwidth extension evaluates a model trained on decimated
audio on the original-rate grid); mdct inverts ``out * scale + mean -
shift`` (then ``exp`` when takelog: the reference's shift-before-exp) and
overlap-adds the ISTMDCT, or the block-switching banks; fft recovers a
phase by Griffin-Lim over the fitted magnitude.  A fused KAN decodes
through kernel G, a fused mlp through the stack kernel."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.coords import get_coord
from ..data.fittings import FittingProblem, hann_window_torch
from ..dsp.adaptive import AdaptivePlan, istmdct_adaptive
from ..dsp.mdct import istmdct
from ..dsp.stft import griffin_lim
from ..device import resolve_device
from ..models import INRModel
from ..tree import tree_map
from ..utils.observability import span


def decode_dense(model: INRModel, params, coords, chunk: int = 1 << 20,
                 fit_snr_db: float | None = None,
                 device: torch.device | str = "cuda") -> np.ndarray:
    """The model over (n, d) coords (numpy or tensor) on ``device`` in
    chunks of ``chunk`` rows -> host (n, out).  ``fit_snr_db`` routes a
    model with a quality-gated decode (fused mlp) through its tier.  Under
    a ``torch.profiler`` session the call is the span ``inr.decode``, with
    ``inr.decode.prepare``, each chunk's ``inr.decode.to_host`` and
    ``inr.decode.gather`` inside it."""
    n = coords.shape[0]
    with span("inr.decode", rows=n, chunks=-(-n // chunk)):
        with span("inr.decode.prepare"):
            dev = resolve_device(device)
            params = tree_map(lambda t: t.to(dev), params)
            coords = torch.as_tensor(coords, dtype=torch.float32).to(dev)
            tiered = (fit_snr_db is not None
                      and model.decode_apply is not None)

        def fn(c):
            if tiered:
                return model.decode_apply(params, c, float(fit_snr_db))
            return model.apply(params, c)

        outs = []
        with torch.no_grad():
            for s in range(0, n, chunk):
                out = fn(coords[s:s + chunk])
                with span("inr.decode.to_host"):
                    outs.append(out.cpu())
        with span("inr.decode.gather"):
            return torch.cat(outs).numpy()


def bwe_coords(problem: FittingProblem,
               coord_scale: float = 1.0) -> np.ndarray:
    """The original-rate grid for a super-resolution decode."""
    duration = problem.height / problem.sample_rate
    n = int(problem.original_sample_rate * duration)
    return get_coord(n, dim=1, scale=coord_scale)


def decode_problem(model: INRModel, params, problem: FittingProblem,
                   bwe: bool = False,
                   encode: Callable[[torch.Tensor], torch.Tensor]
                   | None = None,
                   fit_snr_db: float | None = None,
                   device: torch.device | str = "cuda"
                   ) -> tuple[np.ndarray, int]:
    """Decode a fitted problem -> (waveform, sample_rate) on ``device``.
    ``encode`` maps raw coords (a tensor on the device) to the features the
    model was trained on (RFF, posenc); ``fit_snr_db`` routes a fused mlp
    through its quality-gated tier."""
    dev = resolve_device(device)
    d = problem.decode
    coords, rate = problem.coords, problem.sample_rate
    if bwe:
        if problem.method not in ("wave", "multi"):
            raise ValueError(f"bwe decodes a waveform target, not "
                             f"{problem.method!r}")
        if problem.in_features != 1:
            raise ValueError("bwe decode needs 1-D (time) coordinates; the "
                             f"problem has in_features={problem.in_features}")
        scale = float(np.max(np.abs(problem.coords[:, 0])))
        coords, rate = (bwe_coords(problem, coord_scale=scale),
                        problem.original_sample_rate)
    coords = torch.from_numpy(np.ascontiguousarray(coords)).to(dev)
    if encode is not None:
        coords = encode(coords)
    out = decode_dense(model, params, coords, fit_snr_db=fit_snr_db,
                       device=dev)
    if problem.method in ("wave", "multi"):
        wav = out.reshape(-1) * d.get("peak", 1.0)
        return wav.astype(np.float32), rate
    if problem.method == "mdct":
        spec = out.reshape(-1) * d["scale"] + d["mean"] - d["shift"]
        if d["takelog"]:
            # the reference subtracts the shift before exp, not after
            spec = np.exp(spec)
        spec = torch.as_tensor(spec.astype(np.float32), device=dev)
        if d["kind"] == "mdct_adaptive":
            banks = {kind: spec[start:start + num * bins].reshape(num, bins)
                     for kind, (start, num, bins) in d["bank_slices"].items()}
            plan = AdaptivePlan(n_long=d["n_long"], n_short=d["n_short"],
                                kinds=tuple(d["plan_kinds"]),
                                offsets=tuple(d["plan_offsets"]),
                                num_samples=d["num_samples"])
            wav = istmdct_adaptive(banks, plan)
        else:
            wav = istmdct(spec.reshape(problem.height, problem.width),
                          n=d["n"])
        return wav.cpu().numpy().astype(np.float32), rate
    if problem.method == "fft":
        n_fft = d["n_fft"]
        mag = torch.as_tensor(
            (out.reshape(problem.height, problem.width)
             * d["scale"]).astype(np.float32), device=dev)
        wav = griffin_lim(mag, n_fft=n_fft, hop=n_fft // 4,
                          window=torch.as_tensor(hann_window_torch(n_fft),
                                                 device=dev),
                          length=d.get("length"))
        return wav.cpu().numpy().astype(np.float32), rate
    raise ValueError(f"unknown method {problem.method!r}")
