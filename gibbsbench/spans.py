"""The program's own spans, read from its registry
(``numbskull_tpu_torch.observability.metrics``) by the per-layer readers.

The readers run in the traced run's own process after the window, so the
registry holds every span of that run: set-up's once, and the host loop's
over every call. A program without the span (one older than its spans)
gives None, as does a run of a phase not listed, and a run off the card:
the spans are read as the H100's set-up and host loop, and a traced
slice with no device intervals (the CPU's tiny runs) reports, like the
device readers, none of them.
"""

from __future__ import annotations

#: the phases a set-up span belongs to: both
SETUP = ("learning", "inference")


def _on_card(run: dict) -> bool:
    t = run.get("trace")
    return bool(t) and t.get("busy_s") is not None


def _snapshot():
    from numbskull_tpu_torch.observability import metrics
    return metrics.snapshot()


def total_s(run: dict, phases, name: str):
    """Seconds in span ``name`` over the process, or None."""
    if run.get("phase") not in phases or not _on_card(run):
        return None
    t = _snapshot()["timings"].get(name)
    return t["total_s"] if t else None


def self_us_per_epoch(run: dict, phase: str, name: str, epochs: str):
    """Span ``name``'s self time (its own, its child spans' taken out)
    over the process, in microseconds per epoch of counter ``epochs``;
    or None."""
    if run.get("phase") != phase or not _on_card(run):
        return None
    snap = _snapshot()
    t = snap["timings"].get(name)
    n = snap["counters"].get(epochs)
    if not t or "self_s" not in t or not n:
        return None
    return 1e6 * t["self_s"] / n
