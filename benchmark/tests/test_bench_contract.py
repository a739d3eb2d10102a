"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re
from pathlib import Path

import torch

from benchmark import port
from benchmark.drivers import FAULTS
from benchmark.harness import (HERE, ROOT, applies, config_path, load_bench,
                               make_cell, make_driver, metric_reader)
from benchmark.tests.small import SMALL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names():
    b = load_bench()
    assert set(b) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and (ROOT / p).is_dir() for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names)), kind
        for e in b[kind]:
            allowed = KEYS[kind.rstrip("s")] | (
                {"workloads"} if kind in ("end_to_end", "per_layer") else
                set())
            assert KEYS[kind.rstrip("s")] <= set(e) <= allowed, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for c in b["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert c["file"].startswith(b["paths"][0] + "/")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics_and_bounds():
    b = load_bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers: dict[str, str] = {}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert applies(e2e[m["moves"]], w), (m["name"], w)
        layers.setdefault(m["layer"], m["layer"])
    for w in cells:
        reported = [n for n, m in e2e.items() if applies(m, w)]
        assert "setup_s" in reported and len(reported) >= 2, w
        assert any(applies(m, w) for m in b["per_layer"]), w


def test_check_budget_fits_with_24_cells():
    b = load_bench()
    runs = 2 + 14 * 24
    need = runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_every_file_found_by_name():
    b = load_bench()
    for c in b["configs"]:
        cfg = json.loads(config_path(b, c["name"]).read_text())
        assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v >= 0 for v in limits.values())
    for m in b["per_layer"]:
        assert callable(metric_reader(m["name"]).read)


def test_every_driver_owns_its_door_faults_and_cases():
    """Each cell's driver resolves its door and brings a fault of every
    kind and its calibration cases: nothing outside its file names them."""
    for w in load_bench()["workloads"]:
        cell, _ = make_cell(load_bench(), w["name"], 1, 0.1,
                            torch.device("cpu"), SMALL)
        drv = make_driver(cell)
        assert callable(port.door(drv.door)), w["name"]
        assert all(callable(drv.fault(kind)) for kind in FAULTS), w["name"]
        assert callable(drv.cases), w["name"]
        assert isinstance(drv.cases_after_window, bool), w["name"]


def test_files_under_paths_are_named_from_names():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert all(NAME.match(part) for part in Path(rel).parts), rel
