"""Framed STFT in ``torch.stft``'s onesided layout, its inverse and
Griffin-Lim (port of ``inraudio_tpu/dsp/stft.py``), on the device of the
input tensor.

Matches ``torch.stft(x, n_fft, hop, window=..., center=True,
pad_mode='reflect', onesided=True)``: reflect-pad by n_fft // 2, frame at
``hop``, window, real DFT; (n_fft // 2 + 1, num_frames) with num_frames =
1 + len(x) // hop.  The DFT is the JAX package's basis matmul, frames @
[cos | -sin] at full float32; ``use_fft=True`` computes it with
``torch.fft`` instead, the oracle of the tests.  Everything here is
differentiable (the STFT losses run through it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .mdct import on_device


@functools.lru_cache(maxsize=None)
def _rdft_basis(n_fft: int) -> np.ndarray:
    """(n_fft, 2 (n_fft // 2 + 1)): the onesided real DFT's cos and -sin
    bases side by side, float32."""
    bins = n_fft // 2 + 1
    angle = (2.0 * np.pi * np.arange(n_fft)[:, None]
             * np.arange(bins)[None, :] / n_fft)
    return np.concatenate([np.cos(angle).astype(np.float32),
                           (-np.sin(angle)).astype(np.float32)], axis=1)


def _bin_weights(n_fft: int) -> np.ndarray:
    """(1, 2 bins): the onesided bin weight (1 at DC and Nyquist, 2
    elsewhere) of the real and the imaginary rows."""
    wk = np.full((n_fft // 2 + 1,), 2.0, dtype=np.float32)
    wk[0] = wk[-1] = 1.0
    return np.concatenate([wk, wk])[None, :]


def _irdft_basis(n_fft: int) -> np.ndarray:
    """(2 bins, n_fft): the forward bases transposed."""
    return _rdft_basis(n_fft).T


def frame_signal(x: torch.Tensor, frame_length: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """Overlapping frames of a signal along its last axis -> (...,
    num_frames, frame_length), a view where no padding is needed.  A
    leading axis frames each signal on its own (the JAX package's vmap)."""
    n = x.shape[-1]
    if center:
        pad = frame_length // 2
        if n <= pad:
            raise ValueError(
                f"signal length {n} too short for reflect padding: "
                f"need > frame_length//2 = {pad} samples (torch.stft "
                f"pad_mode='reflect' has the same requirement)")
        x = torch.cat([torch.flip(x[..., 1:pad + 1], [-1]), x,
                       torch.flip(x[..., -(pad + 1):-1], [-1])], -1)
    if x.shape[-1] < frame_length:
        raise ValueError(
            f"signal length {x.shape[-1]} shorter than frame_length "
            f"{frame_length}; pad the signal or reduce n_fft")
    return x.unfold(-1, frame_length, hop)


def stft_real_imag(x, n_fft: int = 1024, hop: int | None = None,
                   window: torch.Tensor | None = None, center: bool = True,
                   use_fft: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Onesided STFT -> (real, imag), each (n_fft // 2 + 1, num_frames);
    a leading axis of x stays in front, and all of its frames go through
    one basis matmul."""
    x = torch.as_tensor(x)
    if hop is None:
        hop = n_fft // 4
    frames = frame_signal(x, n_fft, hop, center=center)
    if window is not None:
        frames = frames * window
    if use_fft:
        spec = torch.fft.rfft(frames, dim=-1)
        return spec.real.transpose(-1, -2), spec.imag.transpose(-1, -2)
    out = torch.matmul(frames, on_device(_rdft_basis, (n_fft,), x.device,
                                         frames.dtype))
    bins = n_fft // 2 + 1
    return (out[..., :bins].transpose(-1, -2),
            out[..., bins:].transpose(-1, -2))


def stft(x, n_fft: int = 1024, hop: int | None = None,
         window: torch.Tensor | None = None, center: bool = True,
         use_fft: bool = False) -> torch.Tensor:
    """Complex STFT, (n_fft // 2 + 1, num_frames), as torch.stft's
    onesided output."""
    real, imag = stft_real_imag(x, n_fft, hop, window, center, use_fft)
    return torch.complex(real, imag)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 1024,
          hop: int | None = None, window: torch.Tensor | None = None,
          center: bool = True, length: int | None = None,
          use_fft: bool = False) -> torch.Tensor:
    """Inverse onesided STFT (torch.istft's conventions): each frame's
    inverse real DFT, the synthesis window, overlap-add, division by the
    overlapped squared window, the centre padding trimmed.  As in the JAX
    package a sample no frame covers decodes to ~0 (the denominator is
    clamped at 1e-11) instead of raising, and a ``length`` past the frames
    is zero-padded."""
    if hop is None:
        hop = n_fft // 4
    if use_fft:
        frames = torch.fft.irfft(torch.complex(real.T, imag.T), n=n_fft,
                                 dim=-1)
    else:
        frames = torch.matmul(
            torch.cat([real, imag]).T * on_device(_bin_weights, (n_fft,),
                                                  real.device),
            on_device(_irdft_basis, (n_fft,), real.device)) / n_fft
    if window is None:
        window = torch.ones((n_fft,), dtype=torch.float32,
                            device=frames.device)
    frames = frames * window
    num_frames = frames.shape[0]
    total = (num_frames - 1) * hop + n_fft

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.fold(
            cols.T[None], (1, total), (1, n_fft), stride=(1, hop)).reshape(-1)

    acc = overlap_add(frames)
    den = overlap_add((window * window).expand(num_frames, n_fft))
    x = acc / torch.clamp(den, min=1e-11)
    if center:
        x = x[n_fft // 2: total - n_fft // 2]
    if length is not None:
        if length > x.shape[0]:
            x = torch.nn.functional.pad(x, (0, length - x.shape[0]))
        x = x[:length]
    return x


def griffin_lim(magnitude, n_fft: int = 1024, hop: int | None = None,
                window: torch.Tensor | None = None, center: bool = True,
                length: int | None = None, n_iters: int = 60,
                momentum: float = 0.99, use_fft: bool = False
                ) -> torch.Tensor:
    """Phase recovery from a magnitude spectrogram -> waveform: fast
    Griffin-Lim (the accelerated iterate t + momentum (t - t_prev)) over
    ``n_iters`` alternating projections, each an inverse and a forward
    STFT, on the magnitude's device."""
    if hop is None:
        hop = n_fft // 4
    mag = torch.as_tensor(magnitude, dtype=torch.float32)
    if length is None:
        length = (mag.shape[1] - 1) * hop

    def project(re, im):
        norm = torch.sqrt(torch.clamp(re * re + im * im, min=1e-16))
        return mag * re / norm, mag * im / norm

    def inverse(re, im):
        return istft(re, im, n_fft=n_fft, hop=hop, window=window,
                     center=center, length=length, use_fft=use_fft)

    re, im = mag, torch.zeros_like(mag)
    pre_re, pre_im = mag, torch.zeros_like(mag)
    for _ in range(n_iters):
        p_re, p_im = project(re + momentum * (re - pre_re),
                             im + momentum * (im - pre_im))
        new_re, new_im = stft_real_imag(inverse(p_re, p_im), n_fft=n_fft,
                                        hop=hop, window=window,
                                        center=center, use_fft=use_fft)
        pre_re, pre_im = re, im
        re, im = new_re[:, :mag.shape[1]], new_im[:, :mag.shape[1]]
    return inverse(*project(re, im))


def stft_magnitude(x, n_fft: int = 1024, hop: int | None = None,
                   window: torch.Tensor | None = None, center: bool = True,
                   eps: float = 0.0, use_fft: bool = False) -> torch.Tensor:
    """Magnitude spectrogram; with eps > 0, sqrt(clamp(re^2 + im^2, eps))
    (auraloss's guard)."""
    real, imag = stft_real_imag(x, n_fft, hop, window, center, use_fft)
    power = real ** 2 + imag ** 2
    if eps > 0.0:
        power = torch.clamp(power, min=eps)
    return torch.sqrt(power)
