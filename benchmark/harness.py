"""Running one cell of ``BENCHMARK.json``: find its files by name, set it up,
time its window, read its metrics, and judge its output against the plain
reference.  Knows no configuration, mix or metric by name."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path
from types import ModuleType
from typing import Any

import torch

from . import check
from .reference.common import set_float32_matmul
from .trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_path(bench: dict, config: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == config:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {config!r} in BENCHMARK.json")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` (a name may hold dots), loaded by path."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's configuration, mix, seed, length
    and device, and the reference module its configuration names.
    ``mark(name)`` notes how far into the run a stage of set-up ended."""
    name: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: torch.device
    ref: ModuleType
    t_start: float = 0.0
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.append([name, time.perf_counter() - self.t_start])


def make_cell(bench: dict, workload: str, seed: int, seconds: float,
              device: torch.device, overrides: dict | None = None
              ) -> tuple[Cell, dict]:
    """(the cell, its limits); ``overrides`` {"cfg": {...}, "mix": {...}}
    replaces keys of the files (the tests' small sizes)."""
    w = find_workload(bench, workload)
    overrides = overrides or {}
    cfg = {**load_json(config_path(bench, w["config"])),
           **overrides.get("cfg", {})}
    mix = {**load_json(HERE / "traffic" / f"{w['traffic']}.json"),
           **overrides.get("mix", {})}
    limits = load_json(HERE / "limits" / f"{workload}.json")
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    return Cell(workload, cfg, mix, seed, seconds, device, ref), limits


def make_driver(cell: Cell):
    """The driver that the cell's mix names, around the cell."""
    return importlib.import_module(
        f"benchmark.drivers.{cell.mix['driver']}").Driver(cell)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             overrides: dict | None = None) -> dict:
    """One run of a cell on ``device`` (the caller has looked for the card);
    ``t_start`` is the host clock when the run began.  Returns the result
    line's fields, the comparison table last."""
    set_float32_matmul()
    cell, limits = make_cell(bench, workload, seed, seconds, device,
                             overrides)
    cell.t_start = t_start
    cell.mark("imports")
    driver = make_driver(cell)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)

    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(trace, device)
    with tracer.window():
        sync()
        t0 = time.perf_counter()
        run = driver.window(seconds, trace)
        sync()
        wall_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    measured = {"setup_s": setup_s, **driver.metrics(run, wall_s)}

    metrics = {}
    summary = tracer.summary() if trace else {}
    if trace:
        ctx = {**run, **summary, "cfg": cell.cfg, "wall_s": wall_s,
               "window_peak_bytes": window_peak}
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = metric_reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": max(peak, window_peak)}
    if trace:
        dev_info["busy_s"] = summary.get("busy_s", 0.0)
        dev_info["window_s"] = summary.get("window_s", wall_s)

    correct, table = check.judge(driver.readings(), limits)
    out = {"correct": correct and run["failed"] == 0,
           "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": dev_info}
    if trace and summary:
        out["breakdown"] = summary["breakdown"]
    out["setup_marks"] = cell.marks
    out["checks"] = table
    return out
