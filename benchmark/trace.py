"""The traced run's reading of the device: a ``torch.profiler`` trace of the
window, reduced to kernel time by name, the device's busy time, and the
idle gaps named by what the host was doing.

The benchmark's own spans (``span``) are ``record_function`` ranges around
its calls into the program; with tracing off they cost nothing.  The trace
is written to a temporary file under ``$TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def span(name: str, enabled: bool):
    """A named host range in the trace, or nothing when not tracing."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Tracer:
    """``with tracer.window(): ...`` profiles the block when enabled;
    ``summary()`` then reduces the trace."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self._events: list[dict] | None = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self._events = [e for e in json.load(f).get("traceEvents", [])
                                if e.get("ph") == "X" and "dur" in e]
        finally:
            os.remove(path)

    def summary(self) -> dict:
        """kernels {name: s}, device_ops {name: s} (kernels and copies),
        busy_s, window_s, and the top ten device ops and idle gaps."""
        events = self._events or []
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            return {}
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        kernels: dict[str, float] = defaultdict(float)
        ops: dict[str, float] = defaultdict(float)
        spans = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t <= s:
                continue
            ops[e["name"]] += (t - s) * 1e-6
            if e["cat"] == "kernel":
                kernels[e["name"]] += (t - s) * 1e-6
            spans.append((s, t))
        busy, gaps = _merge(spans, w0, w1)
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e.get("name") != WINDOW]
        idle = _name_gaps(gaps, host)
        top = lambda d: sorted(([short(k), v] for k, v in d.items()),  # noqa
                               key=lambda kv: -kv[1])[:10]
        return {"kernels": dict(kernels), "device_ops": dict(ops),
                "busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
                "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def short(name: str) -> str:
    """A kernel's name without its argument list and namespaces, at most 96
    characters: ``siren_sweep_kernel<256>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:96].strip()


def _merge(spans: list[tuple[float, float]], w0: float, w1: float
           ) -> tuple[float, list[tuple[float, float]]]:
    """(busy time, idle gaps) of the device within [w0, w1]."""
    busy = 0.0
    gaps = []
    cursor = w0
    for s, t in sorted(spans):
        if s > cursor:
            gaps.append((cursor, s))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps.append((cursor, w1))
    return busy, gaps


def _name_gaps(gaps: list[tuple[float, float]], host: list[dict]
               ) -> dict[str, float]:
    """Seconds of device idle by the innermost host range open at each
    gap's midpoint (on any thread; the latest opened wins), "host idle"
    where none is open."""
    by_thread: dict = defaultdict(list)
    for e in host:
        by_thread[(e.get("pid"), e.get("tid"))].append(
            (float(e["ts"]), -float(e["dur"]), e["name"]))
    queries = sorted(((a + b) / 2, b - a) for a, b in gaps)
    best: list[tuple[float, str] | None] = [None] * len(queries)
    for evs in by_thread.values():
        evs.sort()
        stack: list[tuple[float, float, str]] = []
        i = 0
        for q, (t, _) in enumerate(queries):
            while i < len(evs) and evs[i][0] <= t:
                s, neg_dur, name = evs[i]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, s - neg_dur, name))
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best[q] is None or stack[-1][0] > best[q][0]):
                best[q] = (stack[-1][0], stack[-1][2])
    out: dict[str, float] = defaultdict(float)
    for (_, length), found in zip(queries, best):
        out[found[1] if found else "host idle"] += length * 1e-6
    return dict(out)
