"""JSONL metric streaming (port of the ``MetricsLogger`` / ``read_metrics``
part of ``inraudio_tpu/utils/observability.py``): one JSON object per
line, appended as the fit goes."""

from __future__ import annotations

import json
import os
import time
from typing import Any


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
