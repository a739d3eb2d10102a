"""The readings that a cell's limits are set from: the program's, the
control's and the planted faults', over many seeds in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... \\
        [--seconds 1] [--out readings.jsonl]

For each seed the cell is set up as a run sets it up, and then:

- ``program``: the program's output against the reference (a sound run);
- ``control``: the reference computed with TF32 operands (the nearest
  precision below the configuration's float32 with TF32 off), put in the
  program's place, against the float32 reference;
- the faults, in the reference put in the program's place or in the
  program's own output: ``half_batch`` (half the rows left out, the mean
  over the rest; a population's: half of each window's rows),
  ``unchanged`` (a step that returns its state, or a request that returns
  nothing new), ``altered`` (a leaf moved double: the leaf that moves
  most, or in a population the leaf of one window that moves most; or
  one sample of each answer shifted by the answer's RMS).

The cases are the cell's driver's (its ``cases()``: ``train_cases``,
``population_cases`` or ``decode_cases`` below, or a new driver's own).
A driver whose ``cases_after_window`` is true (the decode's, for its
sample of requests) runs a window of ``--seconds`` at the cell's own load
first.  Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check
from .harness import load_bench, make_cell, make_driver
from .reference.common import set_float32_matmul


def train_cases(drv) -> dict[str, dict[str, float]]:
    ref = drv.reference()
    p0 = drv.params0
    unchanged = {**ref, "params": p0, "best_params": p0}
    # the leaf that moves most, moved double
    big = max(check.counted_leaves(ref["grad"]),
              key=lambda n: float(torch.linalg.vector_norm(
                  ref["params"][n] - p0[n])))
    doubled = {**ref["params"],
               big: p0[big] + 2 * (ref["params"][big] - p0[big])}
    names = check.counted_leaves(ref["grad"])
    change = lambda out: {n: out["params"][n] - p0[n] for n in names}  # noqa
    look = {"loss": [abs(p - r) / abs(r)
                     for p, r in zip(drv.prog["loss"], ref["loss"])],
            "grad": check.leaf_gaps(drv.prog["grad"], ref["grad"], names),
            "change": check.leaf_gaps(change(drv.prog), change(ref), names)}
    control = drv.reference(tf32=True)
    # each leaf's first gradient: the reference's norm and scale, and the
    # program's and the control's distance from it
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa
    g = ref["grad"]
    look["leaves"] = {n: {"ref": norm(g[n]),
                          "scale": norm(ref["grad_scale"][n]),
                          "program": norm(drv.prog["grad"][n] - g[n]),
                          "control": norm(control["grad"][n] - g[n])}
                      for n in names}
    return {
        "look": look,
        "program": check.train_readings(drv.prog, ref, p0),
        "control": check.train_readings(control, ref, p0),
        "half_batch": check.train_readings(
            drv.reference(rows=drv.rows // 2), ref, p0),
        "unchanged": check.train_readings(unchanged, ref, p0),
        "altered": check.train_readings({**ref, "params": doubled}, ref,
                                        p0)}


def population_cases(drv) -> dict[str, dict[str, float]]:
    ref = drv.reference()
    p0 = drv.params0
    read = lambda out: check.population_readings(out, ref, p0)  # noqa
    unchanged = {**ref, "params": p0, "best_params": p0}
    # the (window, leaf) that moves most, moved double in that window
    moved = {n: torch.linalg.vector_norm(
        (ref["params"][n] - p0[n]).double().reshape(p0[n].shape[0], -1),
        dim=1) for n in p0}
    big = max(moved, key=lambda n: float(moved[n].max()))
    w = int(torch.argmax(moved[big]))
    doubled = ref["params"][big].clone()
    doubled[w] = p0[big][w] + 2 * (ref["params"][big][w] - p0[big][w])
    control = drv.reference(tf32=True)
    worst = lambda out: {  # noqa
        key: int(np.argmax(np.abs(out["loss"][i] - ref["loss"][i])
                           / np.abs(ref["loss"][i])))
        for i, key in ((0, "loss1"), (-1, "loss_last"))}
    return {
        "look": {"windows": int(ref["loss"].shape[1]),
                 "program_worst_window": worst(drv.prog),
                 "control_worst_window": worst(control)},
        "program": read(drv.prog),
        "control": read(control),
        "half_batch": read(drv.reference(rows=drv.rows // 2)),
        "unchanged": read(unchanged),
        "altered": read({**ref, "params": {**ref["params"], big: doubled}})}


def decode_cases(drv) -> dict[str, dict[str, float]]:
    ref = drv.reference()
    prog = drv.answers()

    def half(a):
        a = a.clone()
        a[a.shape[0] // 2:] = 0
        return a

    def shifted(a, r):
        a = a.clone()
        a[a.shape[0] // 3] += torch.sqrt(torch.mean(torch.square(r))).cpu()
        return a

    # the answer's buffer never written
    stale = [torch.zeros_like(a) for a in prog]
    return {
        "program": check.decode_readings(list(zip(prog, ref))),
        "control": check.decode_readings(
            list(zip(drv.reference(tf32=True), ref))),
        "half_batch": check.decode_readings(
            [(half(a), r) for a, r in zip(prog, ref)]),
        "unchanged": check.decode_readings(list(zip(stale, ref))),
        "altered": check.decode_readings(
            [(shifted(a, r), r) for a, r in zip(prog, ref)])}


def calibrate(workload: str, seed: int, seconds: float,
              device: torch.device, overrides: dict | None = None) -> dict:
    """Every case's readings of one seed."""
    set_float32_matmul()
    cell, limits = make_cell(load_bench(), workload, seed, seconds, device,
                             overrides)
    driver = make_driver(cell)
    driver.setup()
    if driver.cases_after_window:
        driver.window(seconds, False)
    driver.model = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cases = driver.cases()
    return {"workload": workload, "seed": seed, "limits": limits, **cases}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = calibrate(args.workload, seed, args.seconds, dev)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    for case in ("program", "control", "half_batch", "unchanged", "altered"):
        if case not in rows[0]:
            continue
        for name in rows[0][case]:
            vals = np.array([r[case][name] for r in rows])
            print(f"{case:>10} {name:>10} min {vals.min():.3e} "
                  f"max {vals.max():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
