"""Observability (port of ``inraudio_tpu/utils/observability.py``): JSONL
metric streaming (``MetricsLogger``, ``read_metrics``), profiler traces
(``profile_trace``, around ``torch.profiler`` where the JAX package wraps
``jax.profiler``), and the program's own spans and counters.

``span(name, **attrs)`` marks a layer boundary of a request or a call,
named ``inr.<layer>.<stage>``.  While no ``torch.profiler`` session
records, it returns a shared no-op after one flag read.  While one
records, the span is a profiler range (``_RANGE``), so it lies in the
exported trace on the clock of the card's kernels and copies, and it
appends a ``SpanRecord`` to a bounded store (``spans()``) that holds the
newest session only.  A span opened while no recorded span is
open on its thread is a root: its attrs gain ``seq``, a sequence number,
and ``counters``, the change of each counter over its interval (the
process's counters: adds on other threads count too); the spans inside it
reach it through their ``parent`` ids.

``counter(name)`` is one of a registry of named integer or float sums,
always on, added to where the work happens; ``counters()`` snapshots
them.  The kernel wrappers' launch counts (``ops._nvcc.LaunchCounter``,
one a call of the wrapper) are ``launches.<wrapper>``; ``ops._nvcc.build_library`` adds
the seconds of each library's nvcc run to ``nvcc.build_s.<library>`` and
of its load to ``nvcc.load_s.<library>``."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

STORE_RECORDS = 1 << 20  # the newest records the store keeps
# The profiler range of a recorded span: the profiler's own fast range, a
# cpu_op event (~2 us a span on the CPU against ~18 for
# ``torch.profiler.record_function``'s user_annotation, whose cost a
# traced decode request pays about 14 times).  A torch without it fails
# here, at import, rather than trace at another cost.
_RANGE = torch._C._profiler._RecordFunctionFast


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


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

class Counter:
    """A named sum: ``add(n)`` holds the counter's lock, since ranks on
    threads of one process add to the same counter."""

    __slots__ = ("value", "lock")

    def __init__(self):
        self.value: int | float = 0
        self.lock = threading.Lock()

    def add(self, n: int | float = 1) -> None:
        with self.lock:
            self.value += n


_COUNTERS: dict[str, Counter] = {}
_COUNTERS_LOCK = threading.Lock()


def counter(name: str) -> Counter:
    """The registry's counter ``name``, made at 0 on first use."""
    with _COUNTERS_LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter()
        return c


def counters() -> dict[str, int | float]:
    """Every counter's value now."""
    with _COUNTERS_LOCK:
        return {name: c.value for name, c in _COUNTERS.items()}


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One recorded span: start and end on ``time.perf_counter_ns``,
    ``parent`` the id of the recorded span it was opened in (None for a
    root), ``thread`` its thread's ident."""
    id: int
    parent: int | None
    name: str
    start_ns: int
    end_ns: int
    thread: int
    attrs: dict


_STORE: collections.deque = collections.deque(maxlen=STORE_RECORDS)
_IDS = itertools.count(1)
_SEQ = itertools.count()
_OPEN = threading.local()  # .stack: the ids of the thread's open spans
# a span ran while no profiler recorded: the next recorded span starts a
# new session and empties the store
_stale = False


class _NoSpan:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    """A recorded span: a profiler range and a ``SpanRecord``."""

    __slots__ = ("name", "attrs", "id", "parent", "range", "start", "before")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attrs known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _stale
        if _stale:
            _STORE.clear()
            _stale = False
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        self.before = None
        if self.parent is None:
            self.attrs["seq"] = next(_SEQ)
            self.before = counters()
        stack.append(self.id)
        self.range = _RANGE(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _OPEN.stack.pop()
        if self.before is not None:
            before = self.before
            self.attrs["counters"] = {
                k: v - before.get(k, 0) for k, v in counters().items()
                if v != before.get(k, 0)}
        _STORE.append(SpanRecord(self.id, self.parent, self.name, self.start,
                                 end, threading.get_ident(), self.attrs))
        return None


def span(name: str, **attrs) -> _Span | _NoSpan:
    """``with span("inr.decode", rows=n) as s: ...``; ``s.set(k=v)`` adds
    attrs inside.  A no-op unless a ``torch.profiler`` session records."""
    if not _autograd_profiler._is_profiler_enabled:
        global _stale
        _stale = True
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> list[SpanRecord]:
    """The store's records, in the order the spans closed."""
    return list(_STORE)
