"""Whole runs of each cell on the CPU at a small size, through the port's
plain versions: a sound run, the run with its timed path broken, the
control, and the process's modules."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark import port
from benchmark.calibrate import calibrate
from benchmark.check import judge
from benchmark.drivers import FAULTS
from benchmark.harness import (ROOT, load_bench, make_cell, make_driver,
                               run_cell)
from benchmark.run import forbidden_modules
from benchmark.tests.small import SMALL

CELLS = [w["name"] for w in load_bench()["workloads"]]
CPU = torch.device("cpu")


def _run(workload, trace=False, seed=2 ** 31 + 11):
    return run_cell(load_bench(), workload, seed, 0.3, trace, CPU,
                    time.perf_counter(), SMALL)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_is_correct(workload, trace):
    out = _run(workload, trace)
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    b = load_bench()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in b[kind]
            if workload in m.get("workloads", CELLS)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _driver(workload: str):
    cell, _ = make_cell(load_bench(), workload, 1, 0.1, CPU, SMALL)
    return make_driver(cell)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", FAULTS)
def test_broken_timed_path_is_not_correct(workload, kind, monkeypatch):
    """The cell's driver's fault of each kind, planted in its door."""
    drv = _driver(workload)
    monkeypatch.setitem(port.DOORS, drv.door, drv.fault(kind))
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in TF32 in the program's place fails the cell's
    limits; the program passes them on the same seed."""
    row = calibrate(workload, 5, 0.3, CPU, SMALL)
    assert not judge(row["control"], row["limits"])[0], row["control"]
    assert judge(row["program"], row["limits"])[0], row["program"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    assert "inraudio_tpu_torch" in sys.modules
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "inraudio_tpu.models", object())
    assert forbidden_modules() == ["inraudio_tpu"]


def test_a_run_loads_no_jax():
    code = ("import time, torch; from benchmark.harness import load_bench, "
            "run_cell; from benchmark.tests.small import SMALL; "
            "from benchmark.run import forbidden_modules; "
            "b = load_bench(); [run_cell(b, w['name'], 3, 0.2, False, "
            "torch.device('cpu'), time.perf_counter(), SMALL) for w in "
            "b['workloads']]; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fit.runner_mlp", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fit.runner_mlp", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_run_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert all(math.isfinite(v["value"]) for v in result["metrics"].values())
