"""The loss zoo (port of ``inraudio_tpu/train/losses.py``): MSE, MAE, the
SNR loss, the STFT loss (auraloss's STFTLoss defaults) and its
multi-resolution mean, and ``mix_loss``, ``(1 - alpha) * base + alpha *
stft`` with an optional per-row weight.  Plain PyTorch, differentiable; the
spectral terms run the basis-matmul STFT of ``dsp.stft`` on the
prediction's device.

``mix_loss(..., windows=True)`` is the JAX package's ``vmap(mix_loss)``
over a window population: pred and target carry a leading window axis k
and the result is (k,), every window's loss over its own rows; the STFT
terms frame each window on its own and put every window's frames through
one basis matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.mdct import on_device
from ..dsp.stft import stft_magnitude
from ..dsp.windows import hann_window_periodic

EPS = 1e-8


def _dims(pred: torch.Tensor, windows: bool):
    """The reduction of one loss: every axis, or all but the window axis."""
    return tuple(range(1, pred.dim())) if windows else None


def mse(pred: torch.Tensor, target: torch.Tensor,
        windows: bool = False) -> torch.Tensor:
    return torch.mean(torch.square(pred - target), dim=_dims(pred, windows))


def mae(pred: torch.Tensor, target: torch.Tensor,
        windows: bool = False) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target), dim=_dims(pred, windows))


def weighted_mse(pred, target, weight=None) -> torch.Tensor:
    """MSE with an optional per-row weight (the hearing-threshold mask)."""
    sq = torch.square(pred - target)
    if weight is None:
        return torch.mean(sq)
    return torch.mean(sq * weight)


def snr_loss(pred: torch.Tensor, target: torch.Tensor,
             windows: bool = False) -> torch.Tensor:
    """auraloss.time.SNRLoss: -10 log10(||y||^2 / ||y - x||^2)."""
    dims = _dims(pred, windows)
    res_energy = torch.sum(torch.square(target - pred), dim=dims)
    tgt_energy = torch.sum(torch.square(target), dim=dims)
    return -10.0 * torch.log10(tgt_energy / (res_energy + EPS) + EPS)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    w = hann_window_periodic(win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w


def stft_loss(pred: torch.Tensor, target: torch.Tensor, n_fft: int = 1024,
              hop: int = 256, win_length: int = 1024, w_sc: float = 1.0,
              w_log_mag: float = 1.0, w_lin_mag: float = 0.0,
              windows: bool = False) -> torch.Tensor:
    """Spectral convergence ||Y - X||_F / ||Y||_F plus the L1 of the log
    magnitudes, on the flattened signals (auraloss.freq.STFTLoss); with
    ``windows`` on each window's flattened signal, -> (k,)."""
    window = on_device(_padded_window, (n_fft, win_length), pred.device)
    shape = (pred.shape[0], -1) if windows else (-1,)
    dims = (-2, -1) if windows else None
    x = stft_magnitude(pred.reshape(shape), n_fft=n_fft, hop=hop,
                       window=window, eps=EPS)
    y = stft_magnitude(target.reshape(shape), n_fft=n_fft, hop=hop,
                       window=window, eps=EPS)
    sc = (torch.linalg.vector_norm(y - x, dim=dims)
          / (torch.linalg.vector_norm(y, dim=dims) + EPS))
    log_mag = torch.mean(torch.abs(torch.log(y + EPS) - torch.log(x + EPS)),
                         dim=dims)
    loss = w_sc * sc + w_log_mag * log_mag
    if w_lin_mag:
        loss = loss + w_lin_mag * torch.mean(torch.abs(y - x), dim=dims)
    return loss


# auraloss MultiResolutionSTFTLoss defaults: (n_fft, hop, win_length)
MRSTFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                               resolutions=MRSTFT_RESOLUTIONS,
                               windows: bool = False) -> torch.Tensor:
    """The mean of ``stft_loss`` over (n_fft, hop, win_length)
    resolutions."""
    total = torch.zeros((pred.shape[0],) if windows else (),
                        dtype=torch.float32, device=pred.device)
    for n_fft, hop, win in resolutions:
        total = total + stft_loss(pred, target, n_fft=n_fft, hop=hop,
                                  win_length=win, windows=windows)
    return total / len(resolutions)


BASE_LOSSES = {"mse": mse, "mae": mae, "snr": snr_loss}


def mix_loss(pred: torch.Tensor, target: torch.Tensor, loss_mode: str = "mse",
             alpha: float = 0.0, weight: torch.Tensor | None = None,
             multi_resolution: bool = False,
             windows: bool = False) -> torch.Tensor:
    """``(1 - alpha) * {mse | mae | snr} + alpha * stft``; the spectral
    term only when alpha != 0 (the value is the reference's).

    ``weight`` (one per row, mean 1 over the real rows, 0 on padding)
    weighs every mode: mse and mae scale each row's term, snr both
    energies, and the spectral term sees both signals zeroed where the
    weight is 0.  ``windows``: pred and target (k, n, out), weight (k, n)
    or (k, n, 1) or None, -> the (k,) losses of the windows, each over its
    own rows (the JAX package's ``vmap(mix_loss)``)."""
    dims = _dims(pred, windows)
    if weight is not None:
        lead = (pred.shape[0], -1) if windows else (-1,)
        w = torch.reshape(weight, lead + (1,) * (pred.dim() - len(lead)))
        if loss_mode == "mse":
            base = torch.mean(torch.square(pred - target) * w, dim=dims)
        elif loss_mode == "mae":
            base = torch.mean(torch.abs(pred - target) * w, dim=dims)
        elif loss_mode == "snr":
            res = torch.sum(torch.square(target - pred) * w, dim=dims)
            tgt = torch.sum(torch.square(target) * w, dim=dims)
            base = -10.0 * torch.log10(tgt / (res + EPS) + EPS)
        else:
            raise KeyError(loss_mode)
    else:
        base = BASE_LOSSES[loss_mode](pred, target, windows)
    if alpha == 0.0:
        return base
    if weight is not None:
        live = (w > 0).to(pred.dtype)
        pred = pred * live
        target = target * live
    spec = (multi_resolution_stft_loss(pred, target, windows=windows)
            if multi_resolution else stft_loss(pred, target, windows=windows))
    return (1.0 - alpha) * base + alpha * spec
