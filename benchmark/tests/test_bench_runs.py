"""Whole runs of each cell on the CPU at a small size, through the port's
plain versions: a sound run, the run with its timed path broken, the
control, and the process's modules."""

import dataclasses
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
from benchmark.harness import (ROOT, load_bench, make_cell, make_driver,
                               run_cell)
from benchmark.reference.common import leaves
from benchmark.run import forbidden_modules
from benchmark.tests.small import SMALL
from inraudio_tpu_torch.train.loop import init_train_state

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


def _fit_fault(kind):
    real = port.fit

    def fit(model, coords, targets, cfg, state=None, device=None):
        if kind == "half_batch":
            n = coords.shape[0] // 2
            return real(model, coords[:n], targets[:n], cfg, state=state,
                        device=device)
        res = real(model, coords, targets, cfg, state=state, device=device)
        if kind == "unchanged":
            return dataclasses.replace(res, state=state)
        # altered: the largest leaf moved double
        name, new = max(leaves(res.state.params), key=lambda t: t[1].numel())
        old = dict(leaves(state.params))[name]
        i, key = name.split(".")[1:]
        res.state.params["layers"][int(i)][key] = old + 2 * (new - old)
        return res
    return fit


def _decode_fault(kind):
    real = port.decode_dense

    def decode_dense(model, params, coords, device=None):
        out = real(model, params, coords, device=device).copy()
        if kind == "unchanged":
            out[:] = 0
        elif kind == "half_batch":
            out[out.shape[0] // 2:] = 0
        else:
            out[out.shape[0] // 3] += float((out ** 2).mean() ** 0.5)
        return out
    return decode_dense


def _population_fault(kind):
    real = port.multi_inr_fit

    def multi_inr_fit(model, signal, sample_rate, cfg, train_cfg, seed=0,
                      device=None):
        if kind == "half_batch":
            # each window's step over the first half of its rows
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
            # the states as drawn
            return res._replace(states=init_train_state(
                model, torch.Generator(), train_cfg, device, windows=k))
        if kind == "altered":
            # in one window, the leaf that moved most moved double
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


FAULTS = {"fit": _fit_fault, "decode_dense": _decode_fault,
          "multi_inr_fit": _population_fault}


def _door(workload: str) -> str:
    """The entry of ``port`` that the cell's driver calls."""
    cell, _ = make_cell(load_bench(), workload, 1, 0.1, CPU, SMALL)
    return make_driver(cell).door


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_broken_timed_path_is_not_correct(workload, kind, monkeypatch):
    door = _door(workload)
    monkeypatch.setattr(port, door, FAULTS[door](kind))
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
