"""Metrics registry: process-local counters and timings.

Port of the ``Metrics`` registry of ``numbskull_tpu/observability.py``:
every engine feeds it (epochs run, variable updates, wall time per
phase) and ``--metrics_out`` dumps it as one JSON object. The profiler
hooks of the JAX package (``trace``, ``annotate``) have no counterpart
here yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Metrics:
    """Thread-safe counters + timing accumulators."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timings: dict[str, dict] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            out = {"counters": dict(self._counters), "timings": {}}
            for k, t in self._timings.items():
                d = dict(t)
                d["mean_s"] = t["total_s"] / max(t["count"], 1)
                out["timings"][k] = d
            return out

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


#: process-wide default registry used by the engines
metrics = Metrics()
