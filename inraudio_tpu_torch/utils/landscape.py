"""Loss-landscape scan on a random plane with filter normalisation (port
of ``inraudio_tpu/utils/landscape.py``; Li et al. 2018): two random
directions in parameter space, each leaf scaled row by row to the norm of
the parameter it perturbs, and the loss over a (steps x steps) grid of
offsets around the parameters, on the parameters' device."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


def _filter_normalize(direction: Any, params: Any) -> Any:
    """Each leaf of ``direction`` scaled to the norm of the matching
    ``params`` leaf: per row (the last axis) for a matrix, whole for a
    vector."""
    def norm_leaf(d, p):
        if d.dim() >= 2:
            d_norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
            p_norm = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        else:
            d_norm = torch.linalg.vector_norm(d)
            p_norm = torch.linalg.vector_norm(p)
        return d * (p_norm / (d_norm + 1e-12))
    return tree_map(norm_leaf, direction, params)


def random_plane(loss_fn: Callable[[Any], torch.Tensor], params: Any,
                 generator: torch.Generator, distance: float = 2.0,
                 steps: int = 30, points_per_batch: int = 4) -> np.ndarray:
    """(steps, steps) losses over the filter-normalised random plane
    through ``params``: entry (i, j) is ``loss_fn`` at params + alpha_i d1
    + beta_j d2, alpha and beta ``linspace(-0.5, 0.5, steps) * distance``.

    The two directions are standard normal draws from ``generator`` (a CPU
    generator: the draws do not depend on the device), moved to each
    leaf's device.  The plane's points are evaluated ``points_per_batch``
    at a time: their losses stay on the device and come back to the host
    once a batch.  Each point is a full loss, so only one point's
    activations are alive at once: peak memory is one ``loss_fn`` call's,
    whatever ``steps``."""
    leaves = tree_leaves(params)

    def draw():
        return tree_unflatten(params, [
            torch.randn(p.shape, generator=generator, dtype=torch.float32
                        ).to(device=p.device, dtype=p.dtype)
            for p in leaves])

    d1 = _filter_normalize(draw(), params)
    d2 = _filter_normalize(draw(), params)
    offsets = np.linspace(-0.5, 0.5, steps, dtype=np.float32) * np.float32(
        distance)
    aa, bb = np.meshgrid(offsets, offsets, indexing="ij")
    points = list(zip(aa.reshape(-1).tolist(), bb.reshape(-1).tolist()))
    m = max(1, min(points_per_batch, steps))
    vals = []
    with torch.no_grad():
        for s in range(0, len(points), m):
            batch = []
            for a, b in points[s:s + m]:
                p = tree_map(lambda p0, u, v: p0 + a * u + b * v,
                             params, d1, d2)
                batch.append(loss_fn(p).reshape(()).to(torch.float32))
            vals.append(torch.stack(batch).cpu().numpy())
    return np.concatenate(vals).reshape(steps, steps)


def plot_landscape(surface: np.ndarray, path: str) -> None:
    """Surface plot PNG of a ``random_plane`` scan (matplotlib, Agg)."""
    from ..eval.plots import _pyplot
    plt = _pyplot()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    s = np.asarray(surface)
    x, y = np.meshgrid(np.arange(s.shape[0]), np.arange(s.shape[1]),
                       indexing="ij")
    ax.plot_surface(x, y, s, cmap="viridis", linewidth=0)
    ax.set_title("loss landscape (random plane, filter-normalised)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
