"""Observability (port of ``inraudio_tpu/utils/observability.py``): JSONL
metric streaming (``MetricsLogger``, ``read_metrics``), wall-clock
throughput counters (``StepTimer``) and profiler traces
(``profile_trace``, around ``torch.profiler`` where the JAX package wraps
``jax.profiler``)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator


class MetricsLogger:
    """Append-only JSONL metric stream: ``log({"step": i, "loss": ...})``
    adds a "t" field (seconds since the logger opened) unless given."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, record: dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("t", round(time.time() - self._t0, 4))
        self._f.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class StepTimer:
    """Wall-clock throughput counters: steps/sec and samples/sec since the
    last ``reset`` (the host clock: synchronise the card before reading
    it)."""

    def __init__(self, samples_per_step: int = 0):
        self.samples_per_step = samples_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.time()
        self.steps = 0

    def tick(self, n_steps: int = 1) -> None:
        self.steps += n_steps

    @property
    def elapsed(self) -> float:
        return time.time() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def msamples_per_sec(self) -> float:
        return (self.steps * self.samples_per_step
                / max(self.elapsed, 1e-9) / 1e6)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """``with profile_trace("trace/"):`` records a ``torch.profiler`` trace
    of the block (CPU activity, and the card's kernels when CUDA is
    available) and writes it into ``log_dir`` as a Chrome / Perfetto JSON
    file, ``trace_<pid>_<n>.json``; a no-op when disabled.  The caller
    synchronises the card before the block ends, so that its kernels fall
    inside the trace.  An exception in the block propagates (the trace is
    still stopped)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
