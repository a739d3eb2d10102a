"""Checkpoint / resume: the whole TrainState as one .npz file (port of
``inraudio_tpu/train/checkpoint.py``, the same format).

Leaves are stored as ``leaf_00000``... in the JAX package's tree-flatten
order (dict keys sorted, NamedTuple fields in order) beside a JSON
``__meta__`` with format ``inraudio_tpu.ckpt.v1``; no pickle.  A checkpoint
written by either package loads in the other.  Restoring pours the saved
leaves into a template state of the same model and config.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ..models.siren import params_to_numpy
from ..tree import tree_leaves, tree_unflatten
from .loop import TrainState

FORMAT = "inraudio_tpu.ckpt.v1"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: TrainState,
                    extra: dict[str, Any] | None = None) -> str:
    """Write ``state`` (leaves copied to the host) -> the .npz path."""
    leaves = tree_leaves(params_to_numpy(state))
    arrays = {f"leaf_{i:05d}": np.asarray(x) for i, x in enumerate(leaves)}
    meta = {"num_leaves": len(leaves), "format": FORMAT,
            "extra": extra or {}}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    out = _npz_path(path)
    np.savez(out, **arrays)
    return out


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """The saved leaves in ``template``'s structure, each on its template
    leaf's device (the checkpoint's dtypes kept)."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(bytes(f["__meta__"]).decode("utf-8"))
        leaves = [f[f"leaf_{i:05d}"] for i in range(meta["num_leaves"])]
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has "
            f"{len(t_leaves)}: architecture mismatch")
    for tl, leaf in zip(t_leaves, leaves):
        if tuple(tl.shape) != leaf.shape:
            raise ValueError(
                f"leaf shape mismatch: template {tuple(tl.shape)} vs "
                f"checkpoint {leaf.shape}: architecture mismatch")
    return tree_unflatten(template, [
        torch.from_numpy(np.array(leaf)).to(tl.device)
        for tl, leaf in zip(t_leaves, leaves)])


def checkpoint_extra(path: str) -> dict[str, Any]:
    """The metadata dict stored beside the state."""
    with np.load(path, allow_pickle=False) as f:
        return json.loads(bytes(f["__meta__"]).decode("utf-8"))["extra"]
