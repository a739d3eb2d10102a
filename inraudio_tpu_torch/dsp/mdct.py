"""MDCT / IMDCT and the framed short-time variants (port of
``inraudio_tpu/dsp/mdct.py``), on the device of the input tensor.

The transform is the cosine-basis matmul at full float32 (TF32 is off in
this package):

    MDCT:   X = (2/N) * x @ C         C[n, k] = cos(2 pi / N (n + n0)(k + 0.5))
    IMDCT:  y = 2 * X @ C^T           n0 = (b + 1) / 2

``use_fft=True`` computes the same through ``torch.fft`` (pre-twiddle, FFT,
post-twiddle), the oracle the tests hold the matmul to.

Conventions (the JAX package's): ``stmdct(data, n)`` windows by KBD at hop
n // 2 and returns (n // 2, num_frames) with num_frames = len(data) //
(n // 2); ``istmdct`` inverts frame by frame, windows, and overlap-adds the
two half-frame banks as a shifted sum, the trailing half-frame trimmed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .windows import kbd_window


@functools.lru_cache(maxsize=64)
def on_device(builder, args: tuple, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``builder(*args)`` (a host numpy constant) as a tensor on
    ``device``, made once per (builder, args, device, dtype)."""
    return torch.from_numpy(np.ascontiguousarray(builder(*args))).to(
        device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _mdct_basis(a: int, b: int) -> np.ndarray:
    """C[n, k] = cos(2 pi (n + n0)(k + 0.5) / N) in float64, as float32."""
    n = a + b
    n0 = (b + 1) / 2.0
    ns = np.arange(n)[:, None]
    ks = np.arange(n // 2)[None, :]
    return np.cos(2.0 * np.pi / n * (ns + n0) * (ks + 0.5)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mdct_twiddles(a: int, b: int, inverse: bool):
    """The FFT form's pre- and post-twiddles (complex64)."""
    n = a + b
    n0 = (b + 1) / 2.0
    ns = np.arange(n)
    ks = np.arange(n // 2)
    if inverse:
        pre = np.exp(1j * 2.0 * np.pi * ks * n0 / n)
        post = np.exp(1j * np.pi * (ns + n0) / n)
    else:
        pre = np.exp(-1j * np.pi * ns / n)
        post = np.exp(-1j * 2.0 * np.pi * n0 * (ks + 0.5) / n)
    return pre.astype(np.complex64), post.astype(np.complex64)


def _pre_twiddle(a: int, b: int, inverse: bool) -> np.ndarray:
    return _mdct_twiddles(a, b, inverse)[0]


def _post_twiddle(a: int, b: int, inverse: bool) -> np.ndarray:
    return _mdct_twiddles(a, b, inverse)[1]


def _twiddles(a: int, b: int, inverse: bool, device: torch.device):
    return tuple(on_device(f, (a, b, inverse), device, torch.complex64)
                 for f in (_pre_twiddle, _post_twiddle))


def mdct(frames: torch.Tensor, a: int, b: int,
         use_fft: bool = False) -> torch.Tensor:
    """Forward MDCT of a frame or a batch: (..., a+b) -> (..., (a+b)//2)."""
    n = a + b
    if use_fft:
        pre, post = _twiddles(a, b, False, frames.device)
        spec = torch.fft.fft(frames * pre, dim=-1)[..., : n // 2]
        return (2.0 / n) * torch.real(spec * post)
    return (2.0 / n) * torch.matmul(
        frames, on_device(_mdct_basis, (a, b), frames.device, frames.dtype))


def imdct(coeffs: torch.Tensor, a: int, b: int,
          use_fft: bool = False) -> torch.Tensor:
    """Inverse MDCT: (..., N//2) coefficients -> (..., N) aliased frame."""
    n = a + b
    if use_fft:
        pre, post = _twiddles(a, b, True, coeffs.device)
        padded = torch.zeros(coeffs.shape[:-1] + (n,), dtype=torch.complex64,
                             device=coeffs.device)
        padded[..., : n // 2] = coeffs * pre
        time = torch.fft.ifft(padded, dim=-1) * n
        return 2.0 * torch.real(time * post)
    basis = on_device(_mdct_basis, (a, b), coeffs.device, coeffs.dtype)
    return 2.0 * torch.matmul(coeffs, basis.T)


def num_stmdct_frames(num_samples: int, n: int) -> int:
    """Frame count of stmdct(data, n) for num_samples samples."""
    return num_samples // (n // 2)


def _frame_half_hop(data: torch.Tensor, n: int) -> torch.Tensor:
    """(num_frames, n) frames at hop n // 2: the tail padded by ``half -
    len % half`` (a whole half-frame when it divides), then adjacent
    half-frame rows side by side."""
    half = n // 2
    length = data.shape[0]
    pad = half - (length % half)
    num_frames = length // half
    rows = torch.nn.functional.pad(data, (0, pad)).reshape(-1, half)
    return torch.cat([rows[:-1], rows[1:]], dim=-1)[:num_frames]


def _window(n: int, alpha: float, like: torch.Tensor) -> torch.Tensor:
    return on_device(kbd_window, (n, alpha), like.device, like.dtype)


def stmdct(data, n: int = 1024, alpha: float = 4.0,
           use_fft: bool = False) -> torch.Tensor:
    """Short-time MDCT: 1-D signal -> (n // 2, num_frames) coefficients,
    KBD-windowed, every frame in one matmul."""
    data = torch.as_tensor(data)
    frames = _frame_half_hop(data, n)
    return mdct(frames * _window(n, alpha, data), n // 2, n // 2,
                use_fft=use_fft).T


def istmdct(coeffs, n: int = 1024, alpha: float = 4.0,
            use_fft: bool = False) -> torch.Tensor:
    """Inverse short-time MDCT: (n // 2, num_frames) -> 1-D signal of
    num_frames * n // 2 samples."""
    coeffs = torch.as_tensor(coeffs)
    half = n // 2
    frames = imdct(coeffs.T, half, half, use_fft=use_fft)  # (frames, n)
    frames = frames * _window(n, alpha, frames)
    zero = torch.zeros((1, half), dtype=frames.dtype, device=frames.device)
    acc = (torch.cat([frames[:, :half], zero])
           + torch.cat([zero, frames[:, half:]]))
    return acc.reshape(-1)[: half * coeffs.shape[1]]
