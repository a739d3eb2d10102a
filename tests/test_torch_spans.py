"""The port's spans and counters (``utils/observability.py``) on the CPU: the
spans of ``decode_dense`` and ``fit`` in a ``torch.profiler`` Chrome trace
and in the store, nested under their root; the no-op with no profiler; a
root's counter deltas; ``build_library``'s build and load seconds; the
store's bound and session; and the benchmark's readers of them, on a fake
program and on the small traced runs of its cells.

The stack kernel runs only on a card: its wrapper's spans are held here
with a recording library in place of csrc/siren_stack.cu, the output
coming from the plain version."""

import collections
import contextlib
import json
import math
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import load_bench, metric_reader, run_cell
from benchmark.metrics import _program
from benchmark.tests.small import SMALL
from inraudio_tpu_torch.eval.decode import decode_dense
from inraudio_tpu_torch.models import SirenSnakeTanhConfig, build_model
from inraudio_tpu_torch.ops import _nvcc
from inraudio_tpu_torch.ops import siren_fused as sf
from inraudio_tpu_torch.ops import siren_train as st
from inraudio_tpu_torch.train import loop as tloop
from inraudio_tpu_torch.utils import observability as obs

torch.set_num_threads(1)

CPU = torch.device("cpu")
DECODE = ("inr.decode", "inr.decode.prepare", "inr.stack",
          "inr.stack.prepare", "inr.stack.launch", "inr.decode.to_host",
          "inr.decode.gather")
FIT = ("inr.fit", "inr.fit.prologue", "inr.fit.sync", "inr.fit.round",
       "inr.fit.between_rounds", "inr.fit.epilogue")


class RecordingLibrary:
    """Stands in for the built siren_stack library: accepts each launch."""

    def __getattr__(self, name):
        if not name.startswith("siren_stack_forward"):
            raise AttributeError(name)
        return lambda *args: 0


@pytest.fixture
def stack_on_cpu(monkeypatch):
    """The decode's forward through the stack kernel's wrapper (a recording
    library, no card), its output from the plain version."""
    monkeypatch.setattr(sf.SIREN_STACK, "_lib", RecordingLibrary())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    plain = st.stack_forward_plain

    def forward(params, plan, coords, bt=None):
        sf.SIREN_STACK(params, plan, coords, bt)
        return plain(params, plan, coords, bt)

    monkeypatch.setattr(st, "stack_forward_plain", forward)


def _mlp(fused=True):
    cfg = SirenSnakeTanhConfig(hidden_features=32, first_omega_0=60.0,
                               num_sine=1, num_snake=1)
    return build_model("mlp", cfg, fused=fused, approx_sin=fused)


def _decode():
    model = _mlp()
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    coords = np.linspace(-1, 1, 150, dtype=np.float32)[:, None]
    out = decode_dense(model, params, coords, chunk=64, device="cpu")
    assert out.shape == (150, 1)
    return {"rows": 150, "chunks": 3}


def _fit(fused):
    x = np.linspace(-1, 1, 100, dtype=np.float32)[:, None]
    tloop.fit(_mlp(fused), x, np.sin(3 * x), tloop.TrainConfig(
        total_steps=4, scan_chunk=2), device="cpu")
    return {"steps": 4, "route": "kernel_d" if fused else "autograd"}


CALLS = {"decode": (_decode, DECODE, 3),
         "fit_kernel_d": (lambda: _fit(True), FIT, 2),
         "fit_autograd": (lambda: _fit(False), FIT, 2)}


def _new_session():
    """A span with no profiler: the next recorded span empties the store."""
    with obs.span("inr.off"):
        pass


def _trace(tmp_path, call):
    """(the call's result, the Chrome trace's complete events by name)."""
    _new_session()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X":
            by_name[e["name"]].append(e)
    return got, by_name


@pytest.mark.parametrize("case", list(CALLS))
def test_spans_nest_in_the_trace_and_the_store(case, tmp_path, request):
    if case == "decode":
        request.getfixturevalue("stack_on_cpu")
    call, names, repeated = CALLS[case]
    attrs, by_name = _trace(tmp_path, call)
    root = names[0]
    assert len(by_name[root]) == 1
    r = by_name[root][0]
    for name in names:
        assert by_name[name], name
        for e in by_name[name]:
            assert r["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= r["ts"] + r["dur"]
    # the decode's chunks, the fit's rounds
    child = {"decode": "inr.decode.to_host"}.get(case, "inr.fit.round")
    assert len(by_name[child]) == repeated

    records = obs.spans()
    assert {s.name for s in records} == set(names)
    (top,) = [s for s in records if s.name == root]
    assert top.parent is None and isinstance(top.attrs["seq"], int)
    for key, value in attrs.items():
        assert top.attrs[key] == value
    by_id = {s.id: s for s in records}
    for s in records:
        if s is top:
            continue
        assert "seq" not in s.attrs and "counters" not in s.attrs
        up = s
        while up.parent is not None:
            assert by_id[up.parent].start_ns <= up.start_ns
            assert up.end_ns <= by_id[up.parent].end_ns
            up = by_id[up.parent]
        assert up is top, s.name
    rounds = [s for s in records if s.name == "inr.fit.round"]
    assert [s.attrs for s in rounds] == [{"steps": 2, "tier": "full"}] * (
        len(rounds))


def test_fit_profile_trace_holds_the_round_span(tmp_path):
    x = np.linspace(-1, 1, 100, dtype=np.float32)[:, None]
    tloop.fit(_mlp(), x, np.sin(3 * x), tloop.TrainConfig(
        total_steps=4, scan_chunk=2), device="cpu",
        profile_dir=str(tmp_path / "trace"))
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "inr.fit.round" in names
    assert "inr.fit" not in names  # opened before the trace started


def test_no_profiler_enters_no_profiler_range(monkeypatch, stack_on_cpu):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler")

    monkeypatch.setattr(obs, "_RANGE", refuse)
    obs._STORE.clear()
    assert obs.span("inr.decode", rows=1) is obs.span("inr.fit")
    _decode()
    _fit(True)
    assert obs.spans() == []


def test_a_root_records_its_counters_deltas():
    launches = _nvcc.LaunchCounter("test_wrapper")
    other = obs.counter("test.seconds")
    _new_session()
    with profile(activities=[ProfilerActivity.CPU]):
        before = launches.launches
        with obs.span("inr.test") as root:
            launches.count()
            with obs.span("inr.test.inner"):
                launches.count()
                launches.count()
            other.add(0.25)
            root.set(route="here")
    assert launches.launches == before + 3
    records = {s.name: s for s in obs.spans()}
    assert records["inr.test"].attrs["counters"] == {
        "launches.test_wrapper": 3, "test.seconds": 0.25}
    assert records["inr.test"].attrs["route"] == "here"
    assert "counters" not in records["inr.test.inner"].attrs
    assert records["inr.test.inner"].parent == records["inr.test"].id


def test_the_store_holds_the_newest_session_and_is_bounded(monkeypatch):
    _new_session()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("inr.first"):
            pass
    assert [s.name for s in obs.spans()] == ["inr.first"]
    _new_session()
    monkeypatch.setattr(obs, "_STORE", collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with obs.span(f"inr.second.{i}"):
                pass
    records = obs.spans()
    assert [s.name for s in records] == [f"inr.second.{i}" for i in (2, 3, 4)]
    assert [s.attrs["seq"] for s in records] == sorted(
        s.attrs["seq"] for s in records)


def test_threads_lose_no_count_and_keep_their_own_nesting():
    """More threads than cores add to one counter and open spans under one
    profiler: no add is lost, and each span's parent is its own thread's."""
    launches = _nvcc.LaunchCounter("test_threads")
    n_threads, n = 16, 300
    before = launches.launches
    _new_session()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work(t):
                for _ in range(n):
                    with obs.span(f"inr.thread.{t}"):
                        with obs.span(f"inr.thread.{t}.inner"):
                            launches.count()
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert launches.launches == before + n_threads * n
    records = obs.spans()
    by_id = {s.id: s for s in records}
    assert len(records) == 2 * n_threads * n
    for s in records:
        if s.name.endswith(".inner"):
            parent = by_id[s.parent]
            assert parent.name == s.name[:-len(".inner")]
            assert parent.thread == s.thread


@pytest.mark.parametrize("built", [True, False], ids=["built", "fresh"])
def test_build_library_times_builds_and_loads(built, tmp_path, monkeypatch):
    """A built library adds its load's seconds and no build; a fresh one
    both, each under the library's own name."""
    lib = tmp_path / "lib" / "libfake.so"
    if built:
        lib.parent.mkdir()
        lib.write_bytes(b"")
    monkeypatch.setattr(_nvcc, "library_path", lambda *a: lib)
    monkeypatch.setattr(_nvcc, "find_nvcc", lambda: "nvcc")

    def nvcc(cmd, **kw):
        assert not built, "nvcc ran for a built library"
        time.sleep(0.02)
        with open(cmd[cmd.index("-o") + 1], "wb"):
            pass
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    def load(path):
        time.sleep(0.01)
        loaded.append(path)
        return "handle"

    monkeypatch.setattr(_nvcc.subprocess, "run", nvcc)
    loaded = []
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", load)
    before = obs.counters()
    assert _nvcc.build_library("fake", ["fake.cu"]) == "handle"
    after = obs.counters()
    delta = {n: v - before.get(n, 0) for n, v in after.items()
             if v != before.get(n, 0)}
    assert loaded == [str(lib)] and lib.exists()
    assert set(delta) == ({"nvcc.load_s.fake"} if built else
                          {"nvcc.build_s.fake", "nvcc.load_s.fake"})
    assert delta["nvcc.load_s.fake"] >= 0.01
    if not built:
        assert delta["nvcc.build_s.fake"] >= 0.02


def _record(i, parent, name, start_us, end_us, **attrs):
    return obs.SpanRecord(i, parent, name, start_us * 1000, end_us * 1000,
                          0, attrs)


# Two decode requests, one fit call and two modulated fit calls, in
# microseconds: request 1 takes prepare 100, the stack 100 (the apply's own
# 50, the wrapper's prepare 30 and launch 20), to_host 500 and gather 40;
# request 2 prepare 120 (20 of it inside a span of its own), the stack 130
# (60 + 40 + 30), gather 60.  The modulated calls' prologues hold 4,000 and
# 3,000 (syncs 500 and 1,000), their epilogues 2,000 and 5,000 (syncs 1,500
# and 2,500).
FAKE = [
    _record(1, None, "inr.decode", 0, 1000, seq=0),
    _record(2, 1, "inr.decode.prepare", 0, 100),
    _record(3, 1, "inr.stack", 100, 200),
    _record(4, 3, "inr.stack.prepare", 130, 160),
    _record(5, 3, "inr.stack.launch", 160, 180),
    _record(6, 1, "inr.decode.to_host", 210, 710),
    _record(7, 1, "inr.decode.gather", 710, 750),
    _record(8, None, "inr.decode", 2000, 3000, seq=1),
    _record(9, 8, "inr.decode.prepare", 2000, 2140),
    _record(10, 9, "inr.decode.inner", 2100, 2120),
    _record(11, 8, "inr.stack", 2140, 2270),
    _record(12, 11, "inr.stack.prepare", 2200, 2240),
    _record(13, 11, "inr.stack.launch", 2240, 2270),
    _record(14, 8, "inr.decode.gather", 2900, 2960),
    _record(15, None, "inr.stack.prepare", 4000, 9000, seq=2),
    _record(20, None, "inr.fit", 10_000, 90_000, seq=3, steps=500,
            counters={"launches.siren_step": 500, "nvcc.load_s.kan": 0.5}),
    _record(21, 20, "inr.fit.prologue", 10_000, 13_000),
    _record(22, 21, "inr.fit.sync", 12_000, 12_500),
    _record(23, 20, "inr.fit.round", 13_000, 80_000, steps=500),
    _record(24, 20, "inr.fit.epilogue", 80_000, 90_000),
    _record(25, 24, "inr.fit.sync", 80_000, 89_000),
    _record(30, None, "inr.modfit", 100_000, 200_000, seq=4, steps=40,
            windows=3, rows=6615, counters={"modfit.window_steps": 120}),
    _record(31, 30, "inr.modfit.prologue", 100_000, 104_000),
    _record(32, 31, "inr.modfit.sync", 103_000, 103_500),
    _record(33, 30, "inr.modfit.round", 104_000, 198_000, steps=40),
    _record(34, 30, "inr.modfit.epilogue", 198_000, 200_000),
    _record(35, 34, "inr.modfit.sync", 198_000, 199_500),
    _record(40, None, "inr.modfit", 300_000, 400_000, seq=5, steps=40,
            windows=3, rows=6615, counters={"modfit.window_steps": 120}),
    _record(41, 40, "inr.modfit.prologue", 300_000, 303_000),
    _record(42, 41, "inr.modfit.sync", 302_000, 303_000),
    _record(43, 40, "inr.modfit.round", 303_000, 395_000, steps=40),
    _record(44, 40, "inr.modfit.epilogue", 395_000, 400_000),
    _record(45, 44, "inr.modfit.sync", 395_000, 397_500),
]
FAKE_COUNTERS = {"nvcc.build_s.siren_train": 95.5,
                 "nvcc.load_s.siren_train": 0.125,
                 "nvcc.load_s.siren_stack": 0.125, "launches.siren_step": 900}
# (request 1 + request 2) / 2 requests, in ms; the fit's prologue less its
# sync and the epilogue less its sync; the same of the two modulated calls,
# over 2 calls
READS = {"decode_prep_ms": (0.1 + 0.12) / 2,
         "stack_host_ms": (0.1 + 0.13) / 2,
         "decode_gather_ms": (0.04 + 0.06) / 2,
         "fit_call_host_ms": 2.5 + 1.0,
         "modfit_call_host_ms": ((3.5 + 0.5) + (2.0 + 2.5)) / 2,
         "wrapper_calls_per_step": 1.0,
         "setup_build_s": 95.75}


@pytest.mark.parametrize("program", ["fake", "older", "absent"])
@pytest.mark.parametrize("metric", list(READS))
def test_readers_of_the_program(metric, program, monkeypatch):
    """Each reader against a fake program's store and registry, and None
    from a program without them (an older one, or none)."""
    fake = SimpleNamespace(spans=lambda: list(FAKE),
                           counters=lambda: dict(FAKE_COUNTERS))
    monkeypatch.setattr(_program, "_observability", {
        "fake": lambda: fake, "older": lambda: SimpleNamespace(),
        "absent": lambda: None}[program])
    value = metric_reader(metric).read({})
    if program == "fake":
        assert value == pytest.approx(READS[metric], rel=1e-12)
    else:
        assert value is None


SPAN_METRICS = {m["name"]: m for m in load_bench()["per_layer"]
                if m["name"] in READS}


@pytest.mark.parametrize("workload",
                         [w["name"] for w in load_bench()["workloads"]])
def test_small_traced_runs_read_the_program(workload):
    out = run_cell(load_bench(), workload, 2 ** 31 + 13, 0.3, True, CPU,
                   time.perf_counter(), SMALL)
    assert out["correct"], out["checks"]
    want = {n for n, m in SPAN_METRICS.items()
            if workload in m["workloads"] and m["source"] == "program_span"}
    assert want
    for name in want:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
    if workload.startswith("fit."):
        # the plain versions run on the CPU: no wrapper calls
        assert out["metrics"]["wrapper_calls_per_step"]["value"] == 0
