"""Driver ``fit``: one full-batch fit of a configuration's model to the
seed's clip through the port's public entry ``train.loop.fit``.

Set-up builds the fit's one state from the seed and drives it through
``check_steps`` steps by the window's own call (one step, then the rest,
so that the first gradient can be read from Adam's first moment), then
``warmup_steps`` more, whose rate sets the window's step count.  The
window is one ``fit`` call of that many steps from the same state: rounds
of ``scan_chunk`` steps that read nothing back.  After the window the
reference follows the check steps from the same initial parameters.

Mix keys: ``check_steps``, ``warmup_steps``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import calibrate, check, port
from ..clip import synth_clip, wave_problem
from ..reference.common import leaves, train
from ..trace import span


def _copy(tree) -> dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in leaves(tree)}


class Driver:
    door = "fit"
    cases_after_window = False

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.mix = cell.mix
        self.dev = cell.device

    def _fit(self, steps: int, state):
        return port.door(self.door)(
            self.model, self.coords, self.targets,
            port.train_config(self.cfg, steps), state=state, device=self.dev)

    def setup(self) -> None:
        cfg, dev, seed = self.cfg, self.dev, self.cell.seed
        coords, self.targets = wave_problem(
            synth_clip(seed, cfg["samples"], cfg["sample_rate"]))
        self.coords = torch.from_numpy(coords).to(dev)
        self.rows = coords.shape[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = self.cell.ref.init(cfg, gen, dev)
        self.tree0 = {"layers": [{k: v.clone() for k, v in layer.items()}
                                 for layer in params["layers"]]}
        self.params0 = dict(leaves(self.tree0))
        self.frozen = self.cell.ref.frozen(params)
        self.model = port.build_model(cfg)
        state = port.initial_state(self.model, params, cfg, dev)
        self.cell.mark("inputs")

        res = self._fit(1, state)
        self.cell.mark("first_step")
        self.prog = {"loss": [float(v) for v in res.loss_history],
                     "grad": {n: m.detach() / (1 - check.BETA1)
                              for n, m in leaves(res.state.opt.mu)}}
        res = self._fit(self.mix["check_steps"] - 1, res.state)
        self.prog["loss"] += [float(v) for v in res.loss_history]
        self.prog["params"] = _copy(res.state.params)
        self.prog["best_params"] = _copy(res.state.best_params)
        self.cell.mark("check_steps")

        warm = self.mix["warmup_steps"]
        t0 = time.perf_counter()
        res = self._fit(warm, res.state)
        rate = warm / (time.perf_counter() - t0)
        self.steps = max(1, round(self.cell.seconds * rate))
        self.state = res.state
        self.cell.mark("warmup")

    def window(self, seconds: float, tracing: bool) -> dict:
        with span("bench.fit", tracing):
            res = self._fit(self.steps, self.state)
        losses = np.asarray(res.loss_history, np.float64)
        self.state = None
        return {"steps": self.steps, "attempted": self.steps,
                "failed": int(np.sum(~np.isfinite(losses))),
                "rows": self.rows * self.steps}

    def metrics(self, run: dict, wall_s: float) -> dict[str, float]:
        return {"train_rate": run["steps"] / wall_s}

    def reference(self, tf32: bool = False, rows: int | None = None) -> dict:
        """The reference's check steps from the same initial parameters
        (``tf32``: the control; ``rows``: the first rows only)."""
        cfg, ref = self.cfg, self.cell.ref
        rows = rows or self.rows
        targets = torch.from_numpy(self.targets[:rows]).to(self.dev)
        return train(lambda p, x: ref.forward(p, cfg, x, tf32), self.tree0,
                     self.coords[:rows], targets, cfg,
                     self.mix["check_steps"], cfg["reference_block_rows"],
                     self.frozen)

    def readings(self) -> dict[str, float]:
        """The program's check steps against the reference's, after the
        program's state is gone."""
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        out = self.reference()
        if not all(math.isfinite(v) for v in out["loss"]):
            return {}
        return check.train_readings(self.prog, out, self.params0)

    def cases(self) -> dict[str, dict[str, float]]:
        return calibrate.train_cases(self)

    def fault(self, kind: str):
        """The door with the timed path broken: ``unchanged`` (the call
        returns the state it was given), ``half_batch`` (the fit of the
        first half of the rows), ``altered`` (the largest leaf moved
        double)."""
        real = port.door(self.door)

        def fit(model, coords, targets, cfg, state=None, device=None):
            if kind == "half_batch":
                n = coords.shape[0] // 2
                return real(model, coords[:n], targets[:n], cfg, state=state,
                            device=device)
            res = real(model, coords, targets, cfg, state=state,
                       device=device)
            if kind == "unchanged":
                return dataclasses.replace(res, state=state)
            name, new = max(leaves(res.state.params),
                            key=lambda t: t[1].numel())
            old = dict(leaves(state.params))[name]
            i, key = name.split(".")[1:]
            res.state.params["layers"][int(i)][key] = old + 2 * (new - old)
            return res
        return fit
