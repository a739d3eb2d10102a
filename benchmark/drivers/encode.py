"""Driver ``encode``: the codec's encode of the seed's clip as a window
population, every window's model trained at once, through the port's
public entry ``train.multi_inr.multi_inr_fit``.

The entry cuts the clip into windows, draws the population, builds its
flat state, trains it in rounds of ``scan_chunk`` steps and gathers the
states and the loss history: each call is one whole encode, from the
initial population.  The population is the benchmark's, made on the card
from the seed and handed to the entry through the model's init, so every
call of a run starts from the same parameters.  Set-up drives the window's
own call through 1 step (the first gradient, from Adam's first moment) and
``check_steps`` steps (the losses, the parameters and the best snapshot),
then ``warmup_steps`` steps; the two calls' times give a step's time, which
sizes the window's call to about ``--seconds``.  The window is one call of
that many steps, its prologue and epilogue included.  After the window the
reference follows the check steps of every window from the same
population.

Mix keys: ``check_steps``, ``warmup_steps``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import calibrate, check, port
from ..clip import synth_clip, window_problem
from ..reference.common import leaves
from ..trace import span


def _copy(tree) -> dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in leaves(tree)}


def improvements(losses: np.ndarray) -> int:
    """The (step, window) pairs whose loss beat the window's best so far:
    the steps in which the window's best snapshot was written."""
    best = np.minimum.accumulate(losses, axis=0)
    return int(np.sum(losses[1:] < best[:-1]) + losses.shape[1])


class Driver:
    door = "multi_inr_fit"
    cases_after_window = False

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.mix = cell.mix
        self.dev = cell.device

    def _fit(self, steps: int):
        return port.door(self.door)(
            self.model, self.clip, self.cfg["sample_rate"],
            port.multi_config(self.cfg), port.train_config(self.cfg, steps),
            seed=self.cell.seed, device=self.dev)

    def _timed_fit(self, steps: int):
        t0 = time.perf_counter()
        res = self._fit(steps)
        return res, time.perf_counter() - t0

    def setup(self) -> None:
        cfg, dev, seed = self.cfg, self.dev, self.cell.seed
        self.clip = synth_clip(seed, cfg["samples"], cfg["sample_rate"])
        coords, self.targets, _ = window_problem(
            self.clip, cfg["sample_rate"], cfg["chunk_seconds"],
            cfg["overlap_fraction"])
        self.coords = torch.from_numpy(coords).to(dev)
        self.windows, self.rows = self.targets.shape[:2]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.tree0 = self.cell.ref.init(cfg, gen, dev, self.windows)
        self.params0 = dict(leaves(self.tree0))
        self.model = port.given_init(port.build_model(cfg), self.tree0)
        self.cell.mark("inputs")

        res = self._fit(1)
        self.cell.mark("first_step")
        self.prog = {"grad": {n: m.detach() / (1 - check.BETA1)
                              for n, m in leaves(res.states.opt.mu)}}
        checks = self.mix["check_steps"]
        res, t_check = self._timed_fit(checks)
        self.prog["loss"] = np.asarray(res.loss_history, np.float64)
        self.prog["params"] = _copy(res.states.params)
        self.prog["best_params"] = _copy(res.states.best_params)
        res = None
        self.cell.mark("check_steps")

        warm = self.mix["warmup_steps"]
        _, t_warm = self._timed_fit(warm)
        # a step's time without the call's own: the two calls' difference
        step_s = t_warm / warm
        if warm > checks and t_warm > t_check:
            step_s = (t_warm - t_check) / (warm - checks)
        self.steps = max(1, round(self.cell.seconds / step_s))
        self.cell.mark("warmup")

    def window(self, seconds: float, tracing: bool) -> dict:
        with span("bench.encode", tracing):
            res = self._fit(self.steps)
        losses = np.asarray(res.loss_history, np.float64)
        return {"steps": self.steps, "attempted": self.windows,
                "failed": int(np.sum(~np.all(np.isfinite(losses), axis=0))),
                "windows": self.windows,
                "rows": self.windows * self.rows * self.steps,
                "improved": improvements(losses)}

    def metrics(self, run: dict, wall_s: float) -> dict[str, float]:
        return {"train_rate": run["steps"] / wall_s}

    def reference(self, tf32: bool = False, rows: int | None = None) -> dict:
        """The reference's check steps of every window from the same
        population (``tf32``: the control; ``rows``: each window's first
        rows only)."""
        rows = rows or self.rows
        targets = torch.from_numpy(self.targets[:, :rows]).to(self.dev)
        out = self.cell.ref.train(self.tree0, self.coords[:rows], targets,
                                  self.cfg, self.mix["check_steps"],
                                  self.cfg["reference_block_windows"], tf32)
        out["loss"] = out["loss"].double().cpu().numpy()
        return out

    def readings(self) -> dict[str, float]:
        """The program's check steps against the reference's, after the
        program's state is gone."""
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        out = self.reference()
        if not np.all(np.isfinite(out["loss"])):
            return {}
        return check.population_readings(self.prog, out, self.params0)

    def cases(self) -> dict[str, dict[str, float]]:
        return calibrate.population_cases(self)

    def fault(self, kind: str):
        """The door with the timed path broken: ``unchanged`` (the states
        as drawn), ``half_batch`` (each window's step over the first half
        of its rows, through the model's ``fused_step_ctx["step"]``),
        ``altered`` (in one window, the leaf that moved most moved
        double)."""
        real = port.door(self.door)
        init_state = port.door("train.loop.init_train_state")

        def multi_inr_fit(model, signal, sample_rate, cfg, train_cfg, seed=0,
                          device=None):
            if kind == "half_batch":
                ctx = model.fused_step_ctx
                step = ctx["step"]

                def half(params, mu, nu, best, coords, targets, lr, c1, c2,
                         best_loss, mcfg, plan, gmode, n_valid, *rest, **kw):
                    n = coords.shape[0] // 2
                    return step(params, mu, nu, best, coords[:n],
                                targets[:, :n].contiguous(), lr, c1, c2,
                                best_loss, mcfg, plan, gmode, n, *rest, **kw)
                model = dataclasses.replace(
                    model, fused_step_ctx={**ctx, "step": half})
            res = real(model, signal, sample_rate, cfg, train_cfg, seed=seed,
                       device=device)
            k = res.num_chunks
            if kind == "unchanged":
                return res._replace(states=init_state(
                    model, torch.Generator(), train_cfg, device, windows=k))
            if kind == "altered":
                old = dict(leaves(model.init(None, device, windows=k)))
                new = dict(leaves(res.states.params))
                moved = {n: torch.linalg.vector_norm(
                    (new[n] - old[n]).reshape(k, -1), dim=1) for n in new}
                name = max(moved, key=lambda n: float(moved[n].max()))
                w = int(torch.argmax(moved[name]))
                i, key = name.split(".")[1:]
                leaf = new[name].clone()
                leaf[w] = old[name][w] + 2 * (new[name][w] - old[name][w])
                res.states.params["layers"][int(i)][key] = leaf
            return res
        return multi_inr_fit
