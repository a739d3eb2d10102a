"""Driver ``modfit``: the modulated codec's encode of the seed's clip, one
shared backbone and a modulation row a window fitted together, through the
port's public entry ``train.modulated.modulated_fit``.

The clip is cut into windows as ``chunk_signal`` cuts it and each window
peak-normalised, as the codec's ``encode_modulated`` does.  The backbone is
the reference's, drawn on the card from the seed and handed to the entry
as ``init_shared``; the entry starts the modulations at zero.  Each call
is one whole joint fit from that state: the targets to the card, the init,
rounds of ``scan_chunk`` steps, the best snapshot and the history to the
host.  Set-up drives the window's own call through ``check_steps`` steps
(the losses and the best snapshot), then ``warmup_steps`` steps; the
warm-up call's time over its steps gives a step's time, which sizes the
window's call to about ``--seconds``.  The check call, the process's first
on the card, also pays the card's one-time costs (the GEMM library's
set-up, the allocator's growth to the fit's ~13 GB), which can take as long
as the warm-up call's 13 more steps: the two calls' difference does not
give a step.  The window is one call of that many steps.  After the
window the reference follows the check steps from the same backbone.

The readings (``readings``): ``loss_gap``, the largest gap of a check
step's loss (the mean over every window's rows) over the loss's rounding
size, the norm of the rows' terms over their count (the reference's
``loss_scale``), so that it reads alike at 2 windows and at 1,333, where a
relative gap would shrink as one over the root of the rows; ``loss1_gap``,
the first step's; ``shared_change_gap``, the backbone's change after the
check steps (the best snapshot's) by the worst leaf: the norm of the
difference from the reference's change over the larger of that leaf's
change and the median leaf's (``check.leaf_gaps`` with ``diff``);
``mods_change_gap``, the worst window's change of its modulation row: the
norm of the difference from the reference's row over the larger of the
reference's row and the median window's.  The norms of differences see a
change of the right size in the wrong direction (a sign, a row or a
layer's slice misplaced), which gaps of norms would pass.

Mix keys: ``check_steps``, ``warmup_steps``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import check, port
from ..clip import synth_clip, window_problem
from ..reference.common import leaves, tree_like
from ..trace import span

READINGS = ("loss_gap", "loss1_gap", "shared_change_gap", "mods_change_gap")


def _worst(values) -> float:
    """The largest of ``values`` (0 for none); infinite where one is not
    finite."""
    values = [float(v) for v in values]
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values, default=0.0)


def _copy(tree) -> dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in leaves(tree)}


def _clone(tree: dict) -> dict:
    return {"layers": [{k: v.clone() for k, v in layer.items()}
                       for layer in tree["layers"]]}


def readings(prog: dict, ref: dict, shared0: dict[str, torch.Tensor]
             ) -> dict[str, float]:
    """``prog`` and ``ref``: {"loss": [each check step's], "shared": {leaf:
    best snapshot}, "mods": (k, mod_dim) best snapshot}, ``ref`` also
    {"loss_scale": [each check step's rounding size]}; ``shared0`` the
    backbone both started from (the modulations start at zero)."""
    p_loss = np.asarray(prog["loss"], np.float64)
    r_loss = np.asarray(ref["loss"], np.float64)
    if p_loss.shape != r_loss.shape or not len(r_loss):
        return dict.fromkeys(READINGS, math.inf)
    gaps = np.abs(p_loss - r_loss) / np.asarray(ref["loss_scale"],
                                                np.float64)
    names = list(shared0)
    dev = shared0[names[0]].device
    change = lambda tree: {n: tree[n].to(dev) - shared0[n]  # noqa: E731
                           for n in names}
    shared_gaps = check.leaf_gaps(change(prog["shared"]),
                                  change(ref["shared"]), names, diff=True)
    r_mods = ref["mods"].double()
    r_rows = torch.linalg.vector_norm(r_mods, dim=1)
    scale = torch.clamp(r_rows, min=max(float(torch.median(r_rows)), 1e-30))
    rows_gap = torch.linalg.vector_norm(
        prog["mods"].to(dev).double() - r_mods, dim=1) / scale
    return {"loss_gap": _worst(gaps),
            "loss1_gap": _worst(gaps[:1]),
            "shared_change_gap": _worst(shared_gaps.values()),
            "mods_change_gap": _worst(rows_gap)}


def doubled(shared: dict, mods: torch.Tensor, shared0: dict,
            mods0: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """(backbone, modulations) with the backbone leaf or the modulation row
    that moved most from (``shared0``, ``mods0``) moved double."""
    old = dict(leaves(shared0))
    mods0 = mods0.to(mods.device)
    moved = {n: float(torch.linalg.vector_norm(t - old[n]))
             for n, t in leaves(shared)}
    rows = torch.linalg.vector_norm(mods - mods0, dim=1)
    name = max(moved, key=moved.get)
    shared = _clone(shared)
    mods = mods.clone()
    if float(rows.max()) > moved[name]:
        w = int(torch.argmax(rows))
        mods[w] = mods0[w] + 2 * (mods[w] - mods0[w])
    else:
        i, key = name.split(".")[1:]
        new = shared["layers"][int(i)][key]
        shared["layers"][int(i)][key] = old[name] + 2 * (new - old[name])
    return shared, mods


class Driver:
    door = "train.modulated.modulated_fit"
    cases_after_window = False

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.mix = cell.mix
        self.dev = cell.device

    def _fit(self, steps: int):
        cfg = self.cfg
        return port.door(self.door)(
            self.model_cfg, self.targets, self.coords,
            port.train_config(cfg, steps), device=self.dev,
            film_scale=cfg["film_scale"], mods_lr_mult=cfg["mods_lr_mult"],
            init_shared=_clone(self.tree0["shared"]))

    def setup(self) -> None:
        cfg, dev, seed = self.cfg, self.dev, self.cell.seed
        clip = synth_clip(seed, cfg["samples"], cfg["sample_rate"])
        self.coords, self.targets, _ = window_problem(
            clip, cfg["sample_rate"], cfg["chunk_seconds"],
            cfg["overlap_fraction"])
        self.windows, self.rows = self.targets.shape[:2]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.tree0 = self.cell.ref.init(cfg, gen, dev, self.windows)
        self.shared0 = dict(leaves(self.tree0["shared"]))
        self.model_cfg = port.config("models.siren.SirenSnakeTanhConfig",
                                     cfg)
        self.cell.mark("inputs")

        res = self._fit(self.mix["check_steps"])
        self.prog = {"loss": np.asarray(res.loss_history, np.float64),
                     "shared": _copy(res.shared),
                     "mods": res.mods.detach().clone()}
        res = None
        self.cell.mark("check_steps")

        warm = self.mix["warmup_steps"]
        t0 = time.perf_counter()
        self._fit(warm)
        # the call's own work (on the card ~5 ms of ~730) counted as its
        # steps': the window comes out ~1% short of --seconds
        step_s = (time.perf_counter() - t0) / warm
        self.steps = max(1, round(self.cell.seconds / step_s))
        self.cell.mark("warmup")

    def window(self, seconds: float, tracing: bool) -> dict:
        with span("bench.modfit", tracing):
            res = self._fit(self.steps)
        # the entry returns the population's mean loss a step: a step whose
        # mean is not finite counts every window as failed
        finite = bool(np.all(np.isfinite(res.loss_history)))
        return {"steps": self.steps, "attempted": self.windows,
                "failed": 0 if finite else self.windows,
                "windows": self.windows,
                "rows": self.windows * self.rows * self.steps}

    def metrics(self, run: dict, wall_s: float) -> dict[str, float]:
        return {"train_rate": run["steps"] / wall_s}

    def reference(self, tf32: bool = False, rows: int | None = None) -> dict:
        """The reference's check steps from the same backbone (``tf32``: the
        control; ``rows``: each window's first rows only), best snapshots
        as the program's ``shared`` and ``mods``."""
        rows = rows or self.rows
        coords = torch.from_numpy(self.coords[:rows]).to(self.dev)
        targets = torch.from_numpy(
            np.ascontiguousarray(self.targets[:, :rows])).to(self.dev)
        out = self.cell.ref.train(self.tree0, coords, targets, self.cfg,
                                  self.mix["check_steps"],
                                  self.cfg["reference_block_windows"], tf32)
        return {"loss": out["loss"], "loss_scale": out["loss_scale"],
                "shared": out["best_shared"], "mods": out["best_mods"]}

    def readings(self) -> dict[str, float]:
        """The program's check steps against the reference's, after the
        program's state is gone."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        out = self.reference()
        if not np.all(np.isfinite(out["loss"])):
            return {}
        return readings(self.prog, out, self.shared0)

    def cases(self) -> dict[str, dict[str, float]]:
        """The readings of the program and of the control and the planted
        faults, each in the program's place (``calibrate``)."""
        ref = self.reference()
        mods0 = self.tree0["mods"]
        read = lambda out: readings(out, ref, self.shared0)  # noqa: E731
        shared, mods = doubled(tree_like(self.tree0["shared"], ref["shared"]),
                               ref["mods"], self.tree0["shared"], mods0)
        control = self.reference(tf32=True)
        r_loss = np.asarray(ref["loss"], np.float64)

        def rel(out):
            return (np.abs(np.asarray(out["loss"]) - r_loss) / r_loss
                    ).tolist()
        return {
            # each check step's rounding size over its loss, and the
            # relative gaps the loss readings are made from
            "look": {"scale_over_loss": (np.asarray(ref["loss_scale"])
                                         / r_loss).tolist(),
                     "program_rel": rel(self.prog),
                     "control_rel": rel(control)},
            "program": read(self.prog),
            "control": read(control),
            "half_batch": read(self.reference(rows=self.rows // 2)),
            "unchanged": read({**ref, "shared": self.shared0,
                               "mods": mods0}),
            "altered": read({**ref, "shared": dict(leaves(shared)),
                             "mods": mods})}

    def fault(self, kind: str):
        """The door with the timed path broken: ``unchanged`` (the initial
        backbone and zero modulations returned), ``half_batch`` (each
        window's first half of its rows), ``altered`` (the backbone leaf or
        the modulation row that moved most, moved double)."""
        real = port.door(self.door)

        def modulated_fit(model_cfg, targets, coords, cfg=None, **kw):
            if kind == "half_batch":
                n = coords.shape[0] // 2
                targets, coords = targets[:, :n], coords[:n]
            res = real(model_cfg, targets, coords, cfg, **kw)
            mods0 = torch.zeros_like(res.mods)
            if kind == "unchanged":
                return res._replace(shared=_clone(kw["init_shared"]),
                                    mods=mods0)
            if kind == "altered":
                shared, mods = doubled(res.shared, res.mods,
                                       kw["init_shared"], mods0)
                return res._replace(shared=shared, mods=mods)
            return res
        return modulated_fit
