"""The traced slice of a run: a ``torch.profiler`` trace of a few calls,
reduced to device busy time, time by device operation and idle gaps by
what the host was doing; and the benchmark's own spans around the calls
into the program's layers.

Busy time is the union of every device interval in the trace (kernels,
copies, sets), so a renamed or added kernel still counts; the method is
that of ``chip_smoke.device_busy`` (the device rows of a trace against
the wall time of the slice), here on the timeline rather than summed.
"""

from __future__ import annotations

import contextlib
import time


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """For each of the sorted ``points``, the innermost (span, event) of
    the nested ``host`` events (start, end, name) that contain it."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for m in points:
        while i < len(host) and host[i][0] <= m:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        live = [h for h in stack if h[0] <= m <= h[1]]
        span = next((h for h in reversed(live)
                     if h[2].startswith("gibbsbench.")), None)
        out.append((span, live[-1] if live else None))
    return out


def summarize(events, wall_s: float) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` (name, seconds; the ten
    largest) and ``idle_gaps`` (what the host was doing, seconds; the ten
    largest sums) from profiler ``events``; ``busy_s`` is None when the
    trace holds no device interval. A gap is labelled with the innermost
    benchmark span and the innermost host event of the main thread at
    its middle."""
    from torch.autograd import DeviceType
    dev, host, by_op, threads = [], [], {}, {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or t <= s:
                continue
            dev.append((s, t))
            by_op[e.name] = by_op.get(e.name, 0.0) + (t - s) * 1e-6
        elif t > s:
            host.append((s, t, e.name, e.thread))
            threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get, default=None)
    host = [h[:3] for h in host if h[3] == main]
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    pairs = list(zip(merged, merged[1:]))
    mids = [0.5 * (a[1] + b[0]) for a, b in pairs]
    gaps = {}
    for (a, b), (span, op) in zip(pairs, _innermost(host, mids)):
        label = " > ".join(dict.fromkeys(
            h[2] for h in (span, op) if h is not None)) or "host"
        gaps[label] = gaps.get(label, 0.0) + (b[0] - a[1]) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy if merged else None, "window_s": wall_s,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def traced(fn, cuda: bool):
    """Run ``fn()`` under the profiler; returns (its result, the
    summary). The slice ends in a device synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, summarize(prof.events(), wall)


#: the program's layer entry points the traced run wraps in spans:
#: (module, attribute path, span name)
LAYER_CALLS = (
    ("numbskull_tpu_torch.ops.itemgrid", "ItemGridEngine.__init__",
     "gibbsbench.build_tables"),
    ("numbskull_tpu_torch.ops.itemgrid", "ItemGridEngine.learn_tables",
     "gibbsbench.learn_tables"),
    ("numbskull_tpu_torch.ops.itemgrid", "ItemGridEngine.run",
     "gibbsbench.itemgrid_run"),
    ("numbskull_tpu_torch.ops.itemgrid", "ItemGridEngine.learn",
     "gibbsbench.itemgrid_learn"),
)


@contextlib.contextmanager
def layer_spans():
    """Wrap each of :data:`LAYER_CALLS` in a ``record_function`` span
    for the duration of the block, and restore them after."""
    import functools
    import importlib

    import torch
    undo = []
    try:
        for mod, path, span in LAYER_CALLS:
            owner = importlib.import_module(mod)
            *outer, attr = path.split(".")
            for name in outer:
                owner = getattr(owner, name)
            orig = owner.__dict__[attr]

            def wrapped(*a, _orig=orig, _span=span, **k):
                with torch.profiler.record_function(_span):
                    return _orig(*a, **k)
            setattr(owner, attr, functools.wraps(orig)(wrapped))
            undo.append((owner, attr, orig))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
