"""The port's spans (``observability.span``): each times its block into the
process registry, with its self time beside its total, and marks it
``nsx.<name>`` on the profiler's timeline only while a profiler records;
the program opens each once a call where its set-up, launch loops,
dumps and checkpoints work, and none once an epoch."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from numbskull_tpu_torch import checkpoint, dataloading
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.models import coin_model
from numbskull_tpu_torch.observability import Metrics, metrics, span
from numbskull_tpu_torch.ops import _build
from numbskull_tpu_torch.parallel import bsp

from _torch_threads import cap_threads

cap_threads()

#: the spans a learning or inference call opens through the array entry,
#: by how many times two calls open each (``kernels.load`` needs a card)
CALL_SPANS = {
    "learning": {"compile": 1, "state_init": 1, "itemgrid.build": 1,
                 "itemgrid.learn_tables": 1, "itemgrid.learn": 2,
                 "learning.sweep_s": 2},
    "inference": {"compile": 1, "state_init": 1, "itemgrid.build": 1,
                  "itemgrid.run": 2, "inference.sweep_s": 2},
}


def test_span_times_without_opening_a_region(monkeypatch):
    """With no profiler recording, a span times its block into the
    registry and opens no ``record_function``."""
    def refuse(name):
        raise AssertionError("record_function(%r) opened" % name)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    metrics.reset()
    for _ in range(3):
        with span("test.block"):
            time.sleep(0.002)
    t = metrics.snapshot()["timings"]["test.block"]
    assert t["count"] == 3 and t["total_s"] >= 0.006
    assert t["self_s"] == t["total_s"]


def test_span_regions_nest_under_the_profiler():
    """Under ``torch.profiler.profile`` each span is a region
    ``nsx.<name>``, a child's inside its parent's; a decorated function
    is one too."""
    @span("test.fn")
    def fn():
        time.sleep(0.001)

    metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("test.outer"):
            time.sleep(0.001)
            with span("test.inner"):
                fn()
    ev = {e.name: e.time_range for e in prof.events()
          if e.name.startswith("nsx.")}
    assert set(ev) == {"nsx.test.outer", "nsx.test.inner", "nsx.test.fn"}
    for parent, child in (("outer", "inner"), ("inner", "fn")):
        p, c = ev["nsx.test." + parent], ev["nsx.test." + child]
        assert p.start <= c.start and c.end <= p.end
    assert metrics.snapshot()["timings"]["test.fn"]["count"] == 1


@pytest.mark.parametrize("registry", ["process", "own"])
def test_self_time_is_total_less_children(registry):
    """A timing's ``self_s`` is its total less its children's totals, a
    grandchild counting only in its parent; a block timed on another
    thread meanwhile is no child. Spans and ``Metrics.time`` share the
    one mechanism, so a registry of one's own keeps self time too."""
    m = metrics if registry == "process" else Metrics()
    timed = span if registry == "process" else m.time
    m.reset()

    def elsewhere():
        with timed("test.other"):
            time.sleep(0.01)
    other = threading.Thread(target=elsewhere)
    with timed("test.outer"):
        time.sleep(0.003)
        with timed("test.mid"):
            time.sleep(0.003)
            with timed("test.leaf"):
                time.sleep(0.003)
        with timed("test.mid"):
            with timed("test.side"):
                other.start()
                other.join(timeout=30)
                assert not other.is_alive()
    t = m.snapshot()["timings"]
    assert t["test.mid"]["count"] == 2
    assert t["test.outer"]["self_s"] == pytest.approx(
        t["test.outer"]["total_s"] - t["test.mid"]["total_s"], abs=1e-12)
    assert t["test.mid"]["self_s"] == pytest.approx(
        t["test.mid"]["total_s"] - t["test.leaf"]["total_s"] -
        t["test.side"]["total_s"], abs=1e-12)
    for leaf in ("test.leaf", "test.side", "test.other"):
        assert t[leaf]["self_s"] == t[leaf]["total_s"]
    assert t["test.side"]["total_s"] >= t["test.other"]["total_s"]
    assert t["test.outer"]["self_s"] >= 0.003


def test_self_time_holds_under_many_threads():
    """Threads nesting spans at once, with the interpreter switching
    threads every microsecond: no count or time is lost, and each
    outer span's self time is its total less its child's."""
    n_threads, n_spans = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    metrics.reset()

    def work():
        for _ in range(n_spans):
            with span("test.outer"):
                with span("test.inner"):
                    pass
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    t = metrics.snapshot()["timings"]
    for k in ("test.outer", "test.inner"):
        assert t[k]["count"] == n_threads * n_spans
    assert t["test.outer"]["self_s"] == pytest.approx(
        t["test.outer"]["total_s"] - t["test.inner"]["total_s"], rel=1e-9)
    assert t["test.inner"]["self_s"] == t["test.inner"]["total_s"]


def test_kernel_load_span_on_the_uncached_path(tmp_path, monkeypatch):
    """``load_library`` opens ``kernels.load`` when it builds and opens a
    library, and not when it returns one it holds; the build (nvcc) and
    the dlopen are stood in for."""
    def fake_nvcc(cmd, **kw):
        time.sleep(0.002)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return type("Proc", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    metrics.reset()
    lib = _build.load_library("itemgrid_sweep")
    assert _build.load_library("itemgrid_sweep") is lib
    t = metrics.snapshot()["timings"]["kernels.load"]
    assert t["count"] == 1 and t["total_s"] >= 0.002


def test_cli_job_registry_keys(tmp_path):
    """``--metrics_out`` of a learning and inference job writes the
    set-up, launch-loop and dump spans (each with its self time), and
    learning's variable updates beside inference's; the merged and
    summed timers are gone."""
    w, v, f, fm, _, _ = coin_model(20, evidence=True, fixed=False, seed=1)
    src = str(tmp_path / "coin")
    dataloading.write_factor_graph_files(src, w, v, f, fm)
    out = str(tmp_path / "m.json")
    metrics.reset()
    port_cli.main([src, "-l", "4", "-i", "5", "-b", "2", "-o",
                   str(tmp_path / "out"), "-q", "--device", "cpu",
                   "--metrics_out", out])
    with open(out) as fh:
        snap = json.load(fh)
    assert set(snap["timings"]) == {
        "load.files_s", "compile", "state_init", "itemgrid.build",
        "itemgrid.learn_tables", "itemgrid.learn", "itemgrid.run",
        "learning.sweep_s", "inference.sweep_s", "dump.weights_s",
        "dump.marginals_s"}
    for t in snap["timings"].values():
        assert set(t) == {"count", "total_s", "max_s", "mean_s", "self_s"}
    c = snap["counters"]
    assert c["learning.epochs"] == 4 and c["inference.epochs"] == 7
    assert c["learning.variable_updates"] == 6 * len(v)
    assert c["inference.variable_updates"] == 7 * len(v)
    assert snap["timings"]["itemgrid.run"]["count"] == 1


@pytest.mark.parametrize("phase", sorted(CALL_SPANS))
def test_a_call_opens_each_span_once(phase):
    """Two 6-epoch calls of ``NumbSkull.learning`` or ``.inference`` on a
    graph from the array entry open the set-up spans once (the engine
    and its learn tables are kept) and the launch loop's once a call,
    not once an epoch; each span's self time lies within its total."""
    w, v, f, fm, dm, edges = coin_model(30, evidence=True, fixed=False,
                                        seed=2)
    ns = port_cli.NumbSkull(quiet=True, device="cpu", burn_in=1,
                            n_learning_epoch=5, n_inference_epoch=5)
    metrics.reset()
    ns.loadFactorGraph(w, v, f, fm, dm, edges)
    for _ in range(2):
        getattr(ns, phase)(out=False)
    snap = metrics.snapshot()
    t = snap["timings"]
    assert {k: t[k]["count"] for k in t} == CALL_SPANS[phase]
    for k in t:
        assert 0 <= t[k]["self_s"] <= t[k]["total_s"]
    assert snap["counters"][phase + ".epochs"] == 2 * (
        5 if phase == "learning" else 6)


@pytest.mark.parametrize("phase", ["inference", "learning"])
def test_bsp_runs_an_epoch_a_call_without_spans(phase):
    """Partitioned execution calls every part's engine once an epoch, so
    it takes the launch loops that open no span: only the parts' engine
    builds (and learn tables) reach the registry."""
    w, v, f, fm, dm, edges = coin_model(20, evidence=True, fixed=False,
                                        seed=3)
    part = (np.arange(len(v)) % 2).astype(np.int64)
    metrics.reset()
    pe = bsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                  domain_mask=dm, device="cpu")
    if phase == "inference":
        pe.inference(seed=3, epochs=4, burn=2)
    else:
        pe.learn(seed=5, epochs=3, stepsize=0.1, burn=1)
    t = metrics.snapshot()["timings"]
    assert "itemgrid.run" not in t and "itemgrid.learn" not in t
    assert t["itemgrid.build"]["count"] == 2
    if phase == "learning":
        assert t["itemgrid.learn_tables"]["count"] == 2


def test_checkpoint_save_and_load_are_spans(tmp_path):
    """``checkpoint.save_s`` and ``checkpoint.load_s`` are spans: timed
    into the registry, and regions ``nsx.checkpoint.*`` under the
    profiler."""
    w, v, f, fm, dm, edges = coin_model(10, evidence=True, seed=4)
    ns = port_cli.NumbSkull(quiet=True, device="cpu")
    ns.loadFactorGraph(w, v, f, fm, dm, edges)
    state = ns.factorGraphs[0].state
    path = str(tmp_path / "ck.npz")
    metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        checkpoint.save_checkpoint(path, state, 7, meta={"epochs_done": 1})
        _, seed, meta = checkpoint.load_checkpoint(path, "cpu")
    assert seed == 7 and meta == {"epochs_done": 1}
    names = {e.name for e in prof.events()}
    assert {"nsx.checkpoint.save_s", "nsx.checkpoint.load_s"} <= names
    t = metrics.snapshot()["timings"]
    for k in ("checkpoint.save_s", "checkpoint.load_s"):
        assert t[k]["count"] == 1 and t[k]["self_s"] == t[k]["total_s"]
