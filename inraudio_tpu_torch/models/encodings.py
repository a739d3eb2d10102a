"""Input encodings: Gaussian random Fourier features and NeRF positional
encoding (port of ``inraudio_tpu/models/encodings.py``; plain torch).

The RFF projection B ~ N(0, sigma^2) is drawn from a ``torch.Generator``:
the numbers differ from the JAX package's for the same seed, the
distribution is the same.  Encodings run in float32 (the sin/cos arguments
reach 2 pi sigma |c|, far beyond bf16's resolution there).
"""

from __future__ import annotations

import math

import torch


def rff_init(generator: torch.Generator, input_size: int, encoded_size: int,
             sigma: float = 10.0, device: torch.device | str = "cpu"
             ) -> torch.Tensor:
    """The fixed projection B ~ N(0, sigma^2), shape (encoded_size, d)."""
    b = torch.randn((encoded_size, input_size), generator=generator,
                    dtype=torch.float32)
    return (sigma * b).to(device)


def rff_apply(b: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``[cos(2 pi v B^T), sin(2 pi v B^T)]``: (n, d) -> (n, 2F), cos
    first.  B is a constant: no gradient flows into it."""
    vp = 2.0 * math.pi * coords.to(torch.float32) @ b.detach().T
    return torch.cat([torch.cos(vp), torch.sin(vp)], dim=-1)


def rff_output_dim(encoded_size: int) -> int:
    return 2 * encoded_size


def num_frequencies_nyquist(num_samples: int) -> int:
    """``floor(log2(num_samples / 2))``, the reference's Nyquist count."""
    return int(math.floor(math.log(num_samples / 2.0, 2)))


def posenc_nerf(coords: torch.Tensor, num_frequencies: int,
                include_input: bool = True) -> torch.Tensor:
    """Per-axis ``[sin(2^i pi c), cos(2^i pi c)]`` for i in [0, L): (n, d)
    -> (n, d + 2 d L), the input first."""
    c = coords.to(torch.float32)
    feats = [c] if include_input else []
    for i in range(num_frequencies):
        w = (2.0 ** i) * math.pi
        feats.append(torch.sin(w * c))
        feats.append(torch.cos(w * c))
    return torch.cat(feats, dim=-1)


def posenc_output_dim(in_features: int, num_frequencies: int,
                      include_input: bool = True) -> int:
    return ((in_features if include_input else 0)
            + 2 * in_features * num_frequencies)
