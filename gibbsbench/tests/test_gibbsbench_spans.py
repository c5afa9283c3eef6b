"""The per-layer readers of the program's spans (``source``
``program_span``): each reads the registry of its run's process
(``numbskull_tpu_torch.observability.metrics``), finds nothing outside
its phase, off the card or when its span never ran, and reads every span
a tiny run of its cell opens on the CPU."""

import importlib.util
import json
import os

import pytest

from gibbsbench.tests.helpers import run_tiny
from numbskull_tpu_torch.observability import metrics, span

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
    SPAN_METRICS = [m for m in json.load(f)["per_layer"]
                    if m["source"] == "program_span"]

#: the spans a cell's set-up and window open (PERF.md section 3), except
#: ``kernels.load``, which needs a card
CELL_SPANS = {
    "ehr.learn": {"compile", "state_init", "itemgrid.build",
                  "itemgrid.learn_tables", "itemgrid.learn",
                  "learning.sweep_s"},
    "ehr.infer": {"compile", "state_init", "itemgrid.build",
                  "itemgrid.run", "inference.sweep_s"},
}
#: each reader's own phases
PHASES = {"setup.learn_tables_s": ("learning",),
          "learn.host_us_per_epoch": ("learning",),
          "sweep.host_us_per_epoch": ("inference",)}


#: the traced slice of a run on the card, as far as the readers look
CARD = {"trace": {"busy_s": 0.5, "window_s": 1.0}}


def _on_card(phase):
    return dict(CARD, phase=phase)


def _reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_reader_finds_nothing_outside_its_phase(m):
    read = _reader(m["name"])
    metrics.reset()
    with span("compile"), span("state_init"), span("itemgrid.build"), \
            span("itemgrid.learn_tables"), span("kernels.load"), \
            span("itemgrid.learn"), span("itemgrid.run"):
        pass
    metrics.add("learning.epochs", 3)
    metrics.add("inference.epochs", 3)
    own = PHASES.get(m["name"], ("learning", "inference"))
    assert read({}) is None
    assert read({"phase": "nothing"}) is None
    assert read(_on_card("nothing")) is None
    for phase in {"learning", "inference"} - set(own):
        assert read(_on_card(phase)) is None
    for phase in own:
        assert read(_on_card(phase)) > 0
        assert read({"phase": phase}) is None       # no traced slice
        assert read({"phase": phase,                # no device intervals
                     "trace": {"busy_s": None, "window_s": 1.0}}) is None
    metrics.reset()
    for phase in own:
        assert read(_on_card(phase)) is None        # the span never ran


def test_kernel_load_reader_reads_the_span():
    metrics.reset()
    with span("kernels.load"):
        pass
    t = metrics.snapshot()["timings"]["kernels.load"]
    assert _reader("setup.kernel_load_s")(_on_card("learning")) == \
        t["total_s"]


@pytest.mark.parametrize("cell", sorted(CELL_SPANS))
def test_tiny_traced_run_leaves_its_spans(cell):
    """A tiny traced run of each cell on the CPU leaves every span of its
    set-up and window in the registry. Its result line holds none of the
    span metrics (no device intervals); read as a run on the card would
    be, each of the cell's span readers but ``setup.kernel_load_s``
    gives a positive number."""
    metrics.reset()
    res = run_tiny(cell, trace=True)
    t = metrics.snapshot()["timings"]
    assert CELL_SPANS[cell] <= set(t)
    assert "kernels.load" not in t
    for name in CELL_SPANS[cell]:
        assert 0 <= t[name]["self_s"] <= t[name]["total_s"]
    mine = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert not mine & set(res["metrics"])
    phase = "learning" if cell == "ehr.learn" else "inference"
    assert _reader("setup.kernel_load_s")(_on_card(phase)) is None
    for name in mine - {"setup.kernel_load_s"}:
        assert _reader(name)(_on_card(phase)) > 0, name
