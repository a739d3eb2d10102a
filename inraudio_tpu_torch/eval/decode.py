"""Dense decode of a fitted model (port of ``inraudio_tpu/eval/decode.py``,
the wave method): evaluate the model over the coordinate grid in chunks on
the device, de-normalise by the stored peak; bandwidth extension evaluates
a model trained on decimated audio on the original-rate grid.  A fused KAN
decodes through kernel G, a fused mlp through the stack kernel.  The mdct
and fft methods come with the DSP slice of the port."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.coords import get_coord
from ..data.fittings import FittingProblem
from ..device import resolve_device
from ..models import INRModel
from ..tree import tree_map


def decode_dense(model: INRModel, params, coords, chunk: int = 1 << 20,
                 fit_snr_db: float | None = None,
                 device: torch.device | str = "cuda") -> np.ndarray:
    """The model over (n, d) coords (numpy or tensor) on ``device`` in
    chunks of ``chunk`` rows -> host (n, out).  ``fit_snr_db`` routes a
    model with a quality-gated decode (fused mlp) through its tier."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    coords = torch.as_tensor(coords, dtype=torch.float32).to(dev)
    tiered = fit_snr_db is not None and model.decode_apply is not None

    def fn(c):
        if tiered:
            return model.decode_apply(params, c, float(fit_snr_db))
        return model.apply(params, c)

    with torch.no_grad():
        outs = [fn(coords[s:s + chunk]).cpu()
                for s in range(0, coords.shape[0], chunk)]
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
    """Decode a fitted wave problem -> (waveform, sample_rate) on
    ``device``.  ``encode`` maps raw coords (a tensor on the device) to the
    features the model was trained on (RFF, posenc)."""
    if problem.method != "wave":
        raise NotImplementedError(
            f"decode of method {problem.method!r} comes with the DSP slice "
            "of the port; only 'wave' is ported")
    dev = resolve_device(device)
    if bwe:
        if problem.in_features != 1:
            raise ValueError("bwe decode needs 1-D (time) coordinates; the "
                             f"problem has in_features={problem.in_features}")
        scale = float(np.max(np.abs(problem.coords[:, 0])))
        coords, rate = (bwe_coords(problem, coord_scale=scale),
                        problem.original_sample_rate)
    else:
        coords, rate = problem.coords, problem.sample_rate
    coords = torch.from_numpy(np.ascontiguousarray(coords)).to(dev)
    if encode is not None:
        coords = encode(coords)
    out = decode_dense(model, params, coords, fit_snr_db=fit_snr_db,
                       device=dev)
    wav = out.reshape(-1) * problem.decode.get("peak", 1.0)
    return wav.astype(np.float32), rate
