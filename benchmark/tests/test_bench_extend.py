"""A configuration comes into the benchmark by new files and new entries of
``BENCHMARK.json`` only.

In a copy of the benchmark, a probe cell enters through a door that
``port.py`` does not list (``train.loop.fit`` by its dotted name), with a
driver that brings its own faults and calibration cases, its own
configuration (runner_mlp's), traffic and limits.  At the tests' small
size, with a narrow model (h = 32, so that its five runs take seconds),
its run is correct, each of its faults is not, and calibrate returns its
cases; the copy passes the contract tests; and no file of the benchmark
differs from the original.  Also: the names ``port.door`` refuses."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import port
from benchmark.harness import HERE, ROOT

PROBE_DRIVER = '''"""Driver ``probe``: the ``fit`` driver's run through
``train.loop.fit`` named by its dotted path, with faults and cases of its
own."""

import dataclasses

from .. import calibrate, port
from ..reference.common import leaves
from .fit import Driver as Fit


class Driver(Fit):
    door = "train.loop.fit"

    def cases(self):
        return {**calibrate.train_cases(self), "probe": {"door": 1.0}}

    def fault(self, kind):
        real = port.door(self.door)

        def fit(model, coords, targets, cfg, state=None, device=None):
            if kind == "half_batch":
                coords, targets = coords[::2], targets[::2]
            res = real(model, coords, targets, cfg, state=state,
                       device=device)
            if kind == "unchanged":
                return dataclasses.replace(res, state=state)
            if kind == "altered":
                old = dict(leaves(state.params))
                for i, layer in enumerate(res.state.params["layers"]):
                    for key, new in layer.items():
                        o = old[f"layers.{i}.{key}"]
                        layer[key] = o + 2 * (new - o)
            return res
        return fit
'''

PROBE_RUN = '''
import json, time
import torch
from benchmark import port
from benchmark.calibrate import calibrate
from benchmark.check import judge
from benchmark.drivers import FAULTS
from benchmark.harness import load_bench, make_cell, make_driver, run_cell
from benchmark.tests.small import SMALL
from inraudio_tpu_torch.train.loop import fit

torch.set_num_threads(1)
cpu = torch.device("cpu")
# the small size, and a narrow model: the probe tests the harness
small = {**SMALL, "cfg": {**SMALL["cfg"], "hidden_features": 32}}


def correct():
    return run_cell(load_bench(), "fit.probe", 2 ** 31 + 17, 0.3, False,
                    cpu, time.perf_counter(), small)["correct"]


out = {"sound": correct()}
cell, _ = make_cell(load_bench(), "fit.probe", 1, 0.1, cpu, small)
drv = make_driver(cell)
out["door"] = port.door(drv.door) is fit
for kind in FAULTS:
    port.DOORS[drv.door] = drv.fault(kind)
    out[kind] = correct()
    port.DOORS[drv.door] = fit
row = calibrate("fit.probe", 5, 0.3, cpu, small)
out["cases"] = sorted(row)
out["program"] = judge(row["program"], row["limits"])[0]
print(json.dumps(out))
'''


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """A copy of the benchmark (and a link to the program) with the probe
    cell added as new files and new entries."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "inraudio_tpu_torch").symlink_to(ROOT / "inraudio_tpu_torch")
    added = {
        "drivers/probe.py": PROBE_DRIVER,
        "configs/probe_mlp.json":
            (HERE / "configs" / "runner_mlp.json").read_text(),
        "traffic/probe.json": json.dumps(
            {"driver": "probe", "why": "the fit's closed loop through a "
             "door named by its dotted path", "check_steps": 3,
             "warmup_steps": 16}),
        "limits/fit.probe.json":
            (HERE / "limits" / "fit.runner_mlp.json").read_text()}
    for rel, text in added.items():
        path = root / "benchmark" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    runner = next(c for c in bench["configs"] if c["name"] == "runner_mlp")
    bench["configs"].append({**runner, "name": "probe_mlp",
                             "file": "benchmark/configs/probe_mlp.json"})
    bench["workloads"].append(
        {"name": "fit.probe", "config": "probe_mlp", "traffic": "probe",
         "chips": 1, "why": "a door that port.py does not list"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_rate", "device_idle.train"):
            m["workloads"].append("fit.probe")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    return root, {f"benchmark/{rel}" for rel in added}


def test_a_new_door_comes_in_by_new_files(probe):
    root, added = probe
    out = subprocess.run([sys.executable, "-c", PROBE_RUN], cwd=root,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["door"]
    assert got["sound"], got
    assert not any(got[kind] for kind in ("unchanged", "half_batch",
                                          "altered")), got
    assert {"program", "control", "half_batch", "unchanged", "altered",
            "probe"} <= set(got["cases"]), got["cases"]
    assert got["program"], got
    old = {f"benchmark/{k}": v for k, v in _files(HERE).items()}
    new = {k: v for k, v in _files(root).items()
           if k.startswith("benchmark/")}
    assert set(new) - set(old) == added
    assert {k: new[k] for k in old} == old


def test_the_copy_keeps_the_contract(probe):
    root, _ = probe
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_contract.py"],
        cwd=root, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:]


@pytest.mark.parametrize("name", [
    "os.path.join",                # outside the package
    "train.loop.NamedTuple",       # imported into it, not its own
    "inraudio_tpu.train.loop.fit",  # the JAX package's name
    "train.loop._make_update",     # private
    "ops._nvcc.build_library",     # in a private module
    "train.losses.EPS",            # not callable
    "train.loop.no_such_entry",
    "fit.",
])
def test_door_refuses(name):
    with pytest.raises(ValueError):
        port.door(name)
    assert name not in port.DOORS
