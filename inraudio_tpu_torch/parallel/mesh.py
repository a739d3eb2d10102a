"""Ranks, the all-reduce between them, and the row layout of a sharded fit
(port of ``inraudio_tpu/parallel/mesh.py``).

The JAX package's mesh is single-controller: one program drives every
device and XLA inserts the gradient psum.  PyTorch runs one rank per card
with a collective between them, so the port's mesh is a process group:
``Mesh`` holds the group, this rank's index, the world size and this
rank's device, and does an in-place all-reduce sum (and the all-gather that
collects a window-sharded population).

``make_mesh`` builds it three ways:
- under ``torchrun`` (``WORLD_SIZE`` > 1) it initialises the default group
  and puts each rank on ``cuda:LOCAL_RANK``, with NCCL when each rank has a
  card of its own and gloo when ranks share a card (NCCL refuses two ranks
  on one GPU); the choice follows the layout and is logged;
- around a given group (``group=``), for example one gloo group per thread
  of one process (the tests run ranks so);
- otherwise a world of one on ``device``.

Gloo moves CUDA tensors through host memory: the mesh copies them to the
host, all-reduces there and copies back, explicitly, whatever gloo's own
CUDA support in the installed build.

The row layout is the JAX fit's: the rows are padded to a multiple of
``block * size`` (``pad_to_multiple``) and split into equal shards, so every
rank holds whole row tiles; padded rows carry no loss.  A loss that needs
the whole signal (snr, the STFT term) sees the whole padded clip on every
rank (``whole_signal_arrays``), as the JAX package's partitioner computes
it over its padded batch.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class Mesh:
    """One rank of a 1-D data mesh: ``group`` (a torch.distributed process
    group, None for a world of one), this rank, the world size, this rank's
    device, and the group's backend ("nccl", "gloo"; "none" alone)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str = "none"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        # gloo reduces in host memory: a CUDA tensor goes through a copy
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bits.  Returns ``t``."""
        if self.size == 1:
            return t
        x = self._host(t)
        self.group.allreduce([x]).wait()
        if x is not t:
            t.copy_(x)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along axis 0 in
        rank order, on ``t``'s device."""
        if self.size == 1:
            return t
        x = self._host(t.contiguous())
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self.group.allgather([outs], [x]).wait()
        return torch.cat(outs).to(t.device)

    def span(self, start: float, end: float) -> float:
        """Wall seconds from the first rank's ``start`` to the last rank's
        ``end`` (``time.time()`` stamps; the same on every rank).  Ranks
        that share a card and meet in no collective may run one after the
        other, so no single rank's own interval is the fit's time."""
        if self.size == 1:
            return end - start
        dev = self.device if self.backend == "nccl" else "cpu"
        t = self.all_gather(torch.tensor([[start, end]], dtype=torch.float64,
                                         device=dev))
        return float(t[:, 1].max() - t[:, 0].min())


def _log(msg: str) -> None:
    print(f"inraudio_tpu_torch: {msg}", file=sys.stderr, flush=True)


def make_mesh(device: torch.device | str = "cuda", group=None) -> Mesh:
    """This rank's mesh: around ``group`` when given; under ``torchrun``
    (``WORLD_SIZE`` > 1) the default group, initialised here if it is not
    yet (NCCL when every rank has a card of its own, gloo when ranks share
    one or run on the CPU); otherwise a world of one on ``device``.  A card
    that is not there raises."""
    dev = resolve_device(device)
    if group is not None:
        return Mesh(group, group.rank(), group.size(), dev,
                    backend=group.name())
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return Mesh(None, 0, 1, dev)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= cards else "gloo"
        why = (f"{local_size} ranks on {cards} card(s): "
               + ("one card each" if backend == "nccl" else
                  "ranks share a card, all-reduce staged through host memory"))
    else:
        backend, why = "gloo", "CPU ranks"
    if not dist.is_initialized():
        if backend == "gloo" and local_size == world:
            # every rank on this host: gloo's pairs over the loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend)
    pg = dist.distributed_c10d._get_default_group()
    mesh = Mesh(pg, dist.get_rank(), dist.get_world_size(), dev,
                backend=dist.get_backend())
    if mesh.rank == 0:
        _log(f"mesh of {mesh.size} ranks, backend {mesh.backend} ({why})")
    return mesh


def resolve_mesh(mesh: Mesh | None,
                 device: torch.device | str | None) -> Mesh:
    """The mesh an entry point runs on: ``mesh`` when given, else
    ``make_mesh(device)`` (the card when ``device`` is None).  A ``device``
    given beside a mesh must be the mesh's own: the mesh places the fit."""
    if mesh is None:
        return make_mesh("cuda" if device is None else device)
    if device is not None:
        want, have = torch.device(device), mesh.device
        if want.type == have.type == "cuda":  # "cuda" is the current card
            want, have = (d.index if d.index is not None
                          else torch.cuda.current_device()
                          for d in (want, have))
        if want != have:
            raise ValueError(f"device {device!r} differs from the mesh's "
                             f"device {mesh.device}; the mesh places the run")
    return mesh


def pad_to_multiple(x: np.ndarray, multiple: int,
                    pad_value: float = 0.0) -> tuple[np.ndarray, int]:
    """Pad axis 0 up to a multiple of ``multiple``.  Returns (padded,
    original_length); padded rows carry no loss downstream."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.full((rem,) + x.shape[1:], pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n


class RowShard(NamedTuple):
    """This rank's rows of a clip padded to ``size`` equal shards:
    ``[start, start + rows)``, of which the first ``valid`` are real."""
    start: int
    rows: int
    valid: int


def shard_rows(mesh: Mesh, n: int, block: int = 1) -> RowShard:
    """This rank's row range: ``n`` rows padded to a multiple of ``block *
    size`` (at least one block per rank, as the JAX fit pads them for its
    kernels), split into equal shards."""
    unit = block * mesh.size
    n_pad = -(-max(n, unit) // unit) * unit
    rows = n_pad // mesh.size
    start = mesh.rank * rows
    return RowShard(start, rows, int(np.clip(n - start, 0, rows)))


def normalise_weight(weight) -> np.ndarray:
    """A per-row loss weight (n,) or (n, 1) -> float32 (n, 1) of mean 1
    over the rows, normalised on the host as the JAX package's fit does."""
    w = np.asarray(weight, np.float32).reshape(-1)
    return (w * (len(w) / max(float(np.sum(w)), 1e-12)))[:, None]


def shard_problem_arrays(mesh: Mesh, coords: np.ndarray, targets: np.ndarray,
                         block: int = 1, weight: np.ndarray | None = None):
    """This rank's (coords (rows, d), targets (rows, out), weight (rows, 1)
    or None) as float32 on its device, zero past the clip's end, and its
    ``RowShard``.  A per-row loss ``weight`` (n,) or (n, 1) is normalised
    to mean 1 over the clip's real rows before the split, so every shard's
    loss is over the same normaliser, and padded rows get weight 0 (the
    JAX package normalises over the padded batch and divides the loss by
    it: the same loss)."""
    sh = shard_rows(mesh, coords.shape[0], block)
    return (shard_array(mesh, sh, coords), shard_array(mesh, sh, targets),
            None if weight is None
            else shard_array(mesh, sh, normalise_weight(weight)), sh)


def shard_array(mesh: Mesh, sh: RowShard, a: np.ndarray) -> torch.Tensor:
    """The rows ``sh`` of a host array (n, ...) as float32 (sh.rows, -1) on
    the rank's device, zero past the clip's end."""
    a = np.asarray(a, np.float32)
    a = a.reshape(a.shape[0], -1)
    part = np.zeros((sh.rows, a.shape[1]), np.float32)
    part[:sh.valid] = a[sh.start:sh.start + sh.valid]
    return torch.from_numpy(part).to(mesh.device)


def whole_signal_arrays(mesh: Mesh, targets: np.ndarray,
                        weight: np.ndarray | None = None):
    """The whole clip as a loss that needs the whole signal sees it on a
    mesh, on this rank's device: (targets (n_pad, out), weight (n_pad, 1)
    or None), n_pad = ``shard_rows(mesh, n)``'s rows times the ranks, the
    rows the gathered prediction holds (the JAX package's padding to a
    multiple of its devices).  Targets are zero on the padding.  As in the
    JAX package's ``shard_problem_arrays``, the weight, or ones over the
    real rows when rows were padded, is normalised to mean 1 over the
    padded batch and is 0 on the padding; with neither it is None."""
    t = np.asarray(targets, np.float32)
    n = t.shape[0]
    t = t.reshape(n, -1)
    n_pad = shard_rows(mesh, n).rows * mesh.size
    full = np.zeros((n_pad, t.shape[1]), np.float32)
    full[:n] = t
    w = None
    if weight is not None or n_pad != n:
        w = np.zeros((n_pad, 1), np.float32)
        w[:n] = (np.ones((n, 1), np.float32) if weight is None
                 else np.asarray(weight, np.float32).reshape(n, 1))
        w = w * (n_pad / max(float(np.sum(w)), 1e-12))
    return (torch.from_numpy(full).to(mesh.device),
            None if w is None else torch.from_numpy(w).to(mesh.device))
