"""Metrics, tracing, and profiling.

Port of ``numbskull_tpu/observability.py``:

- ``Metrics``: a process-local registry of counters and timings that
  every engine feeds (epochs run, variable updates, wall time per
  phase); ``--metrics_out`` dumps it as one JSON object. A timing
  nested in another (on one thread) is its child: the registry keeps
  each name's self time, its duration less its children's.
- ``span``: a block timed into the process registry and, while the
  torch profiler records, a region ``nsx.<name>`` on its timeline.
- ``trace``: a ``torch.profiler`` trace of the enclosed block (the host,
  and the card's kernels and copies when one is visible), exported as a
  Chrome trace into a directory; the counterpart of the JAX package's
  XPlane trace.
- ``annotate``: a named region (``torch.profiler.record_function``),
  opened whether or not a profiler records.
- ``device_memory_stats``: bytes in use and the limit per visible card.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Metrics:
    """Thread-safe counters + timing accumulators. Each timing holds
    ``count``, ``total_s``, ``max_s`` and ``self_s``: the total less the
    time of the timings :meth:`time` opened inside it on the same
    thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timings: dict[str, dict] = {}
        self._open = threading.local()   # per thread: children's seconds

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0,
                       "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += seconds
            t["max_s"] = max(t["max_s"], seconds)
            t["self_s"] += seconds

    @contextlib.contextmanager
    def time(self, name: str):
        """Time the block under ``name``; a block timed inside it on the
        same thread is its child."""
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            children = stack.pop()
            if stack:
                stack[-1] += dt
            self.observe(name, dt)
            if children:
                with self._lock:
                    self._timings[name]["self_s"] -= children

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


@contextlib.contextmanager
def span(name: str):
    """Time the block into :data:`metrics` under ``name`` and, only while
    the torch profiler records, mark it ``nsx.<name>`` on the profiler's
    timeline (on the clock of the card's kernels and copies). A region
    costs microseconds even with no profiler, so none is opened then.
    Usable as a decorator."""
    import torch
    with metrics.time(name):
        if torch.autograd._profiler_enabled():
            with annotate("nsx." + name):
                yield
        else:
            yield


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
