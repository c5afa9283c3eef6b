"""Metrics, tracing, and profiling.

Port of ``numbskull_tpu/observability.py``:

- ``Metrics``: a process-local registry of counters and timings that
  every engine feeds (epochs run, variable updates, wall time per
  phase); ``--metrics_out`` dumps it as one JSON object.
- ``trace``: a ``torch.profiler`` trace of the enclosed block (the host,
  and the card's kernels and copies when one is visible), exported as a
  Chrome trace into a directory; the counterpart of the JAX package's
  XPlane trace.
- ``annotate``: a named region (``torch.profiler.record_function``), so
  that chunks and phases are attributable inside a trace.
- ``device_memory_stats``: bytes in use and the limit per visible card.
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


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block: CPU
    activity, and CUDA kernels and copies when a card is visible. On
    exit the trace is written to ``logdir/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto, TensorBoard)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named trace region (shows up on the profiler's timeline)."""
    import torch
    return torch.profiler.record_function(name)


def device_memory_stats() -> list[dict]:
    """Per-card memory stats: ``bytes_in_use`` (allocated through
    PyTorch's caching allocator) and ``bytes_limit`` (the card's total
    memory), one entry per visible card; with no card visible, one
    ``cpu`` entry with None values, as the JAX function gives on its CPU
    backend. It only reports: it runs and allocates nothing."""
    import torch
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None,
                 "bytes_limit": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({"device": "cuda:%d" % i,
                    "bytes_in_use": s.get("allocated_bytes.all.current", 0),
                    "bytes_limit":
                        torch.cuda.get_device_properties(i).total_memory})
    return out
