"""Failure recovery, fault injection, stall detection, metrics and the
profiler hooks of the port, on the CPU.

Mirrors tests/test_resilience.py: a run on the tensor-op GibbsEngine
that fails and resumes from its checkpoint produces the same state, bit
for bit, as an uninterrupted one. The profiler hooks
(``observability.trace``, ``annotate``, ``device_memory_stats``) are the
counterparts of numbskull_tpu/observability.py:81-112.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import coin_model
from numbskull_tpu_torch.numbskull import FactorGraph
from numbskull_tpu_torch.observability import (Metrics, annotate,
                                               device_memory_stats, metrics,
                                               trace)
from numbskull_tpu_torch.ops.gibbs import GibbsEngine
from numbskull_tpu_torch.resilience import (FaultInjector, StallError,
                                            call_with_timeout, run_resilient)


def _engine(copies=3):
    w, v, f, fm, dm, _ = coin_model(
        copies, 0.3, -0.2, 0.4, evidence=False,
        weight_init=(0.3, -0.2, 0.4), fixed=True)
    return GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                       device="cpu")


def test_resilient_run_bit_exact_after_faults(tmp_path):
    """Faults before chunks 1 and 3, each retried from the last
    checkpoint: tallies and values equal the clean run's; two retries
    counted."""
    eng = _engine()
    clean = run_resilient(eng, eng.init_state(), 7, epochs=200,
                          ckpt_path=str(tmp_path / "clean.npz"), chunk=50)
    metrics.reset()
    faulty = run_resilient(eng, eng.init_state(), 7, epochs=200,
                           ckpt_path=str(tmp_path / "faulty.npz"), chunk=50,
                           fault_hook=FaultInjector(fail_at=(1, 3)))
    assert torch.equal(clean.count, faulty.count)
    assert torch.equal(clean.var_value, faulty.var_value)
    counters = metrics.snapshot()["counters"]
    assert counters["resilience.retries"] == 2
    assert counters["resilience.chunks"] == 4
    assert counters["resilience.epochs"] == 200


def test_resilient_chunks_equal_one_call(tmp_path):
    """Chunk c draws from the base seed at its first epoch's absolute
    index, so the chunked run equals GibbsEngine.inference in one call
    with the same burn-in."""
    eng = _engine()
    chunked = run_resilient(eng, eng.init_state(), 5, epochs=90,
                            ckpt_path=str(tmp_path / "c.npz"), chunk=40,
                            burn=4)
    whole = eng.inference(eng.init_state(), 5, 90, burn=4)
    assert torch.equal(chunked.count, whole.count)
    assert torch.equal(chunked.var_value, whole.var_value)


def test_resilient_resume_across_processes(tmp_path):
    """Elastic restart: a second invocation picks up where a dead one
    stopped (from the checkpoint's state and seed, even when given
    another seed) and finishes identically."""
    eng = _engine()
    ckpt = str(tmp_path / "resume.npz")
    clean = run_resilient(eng, eng.init_state(), 3, epochs=120,
                          ckpt_path=str(tmp_path / "ref.npz"), chunk=40)
    with pytest.raises(RuntimeError):
        run_resilient(eng, eng.init_state(), 3, epochs=120,
                      ckpt_path=ckpt, chunk=40, max_retries=0,
                      fault_hook=FaultInjector(fail_at=(2,)))
    metrics.reset()
    resumed = run_resilient(eng, eng.init_state(), 99, epochs=120,
                            ckpt_path=ckpt, chunk=40)
    assert torch.equal(clean.count, resumed.count)
    counters = metrics.snapshot()["counters"]
    assert counters["resilience.resumes"] == 1
    assert counters["resilience.epochs"] == 40


def test_call_with_timeout_detects_stall():
    with pytest.raises(StallError):
        call_with_timeout(time.sleep, 0.2, 5.0)
    assert call_with_timeout(lambda x: x + 1, 5.0, 41) == 42


def test_metrics_registry():
    m = Metrics()
    m.add("epochs", 10)
    m.add("epochs", 5)
    with m.time("sweep"):
        time.sleep(0.01)
    snap = m.snapshot()
    assert snap["counters"]["epochs"] == 15
    assert snap["timings"]["sweep"]["count"] == 1
    assert snap["timings"]["sweep"]["total_s"] > 0


def test_engine_feeds_default_metrics():
    metrics.reset()
    eng = _engine()
    fg = FactorGraph(eng.cg, 0, device="cpu")
    fg.inference(0, 5)
    snap = metrics.snapshot()
    assert snap["counters"]["inference.epochs"] >= 5


def test_resilient_learning_bit_exact_after_faults(tmp_path):
    """run_resilient(task='learning'): chunked learning recovers bit for
    bit from faults before chunks 1 and 2, continuing the step size's
    decay at the chunk's absolute epoch index."""
    w, v, f, fm, dm, _ = coin_model(50, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    kw = dict(epochs=80, chunk=20, task="learning", stepsize=0.05,
              decay=0.97)
    clean = run_resilient(eng, eng.init_state(), 11,
                          ckpt_path=str(tmp_path / "cl.npz"), **kw)
    faulty = run_resilient(eng, eng.init_state(), 11,
                           ckpt_path=str(tmp_path / "fl.npz"),
                           fault_hook=FaultInjector(fail_at=(1, 2)), **kw)
    assert torch.equal(clean.weight_value, faulty.weight_value)
    assert torch.equal(clean.var_value_evid, faulty.var_value_evid)
    assert torch.equal(clean.var_value, faulty.var_value)
    assert not np.array_equal(clean.weight_value.numpy(), [0.0, 0.0, 0.0])


def test_trace_writes_annotated_chrome_trace(tmp_path):
    """trace() writes a Chrome trace of the block on the CPU, holding
    the annotate() region and the engine's aten ops."""
    eng = _engine()
    logdir = str(tmp_path / "tr")
    with trace(logdir):
        with annotate("nsx.chunk"):
            eng.inference(eng.init_state(), 1, 3)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "nsx.chunk" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_checkpointed_cli_chunks_are_annotated(tmp_path):
    """Each chunk of a checkpointed FactorGraph run is an ``nsx.chunk``
    region in a trace: three chunks of 2 epochs, three regions."""
    eng = _engine()
    fg = FactorGraph(eng.cg, 0, device="cpu", engine="xla")
    with trace(str(tmp_path / "tr")) as prof:
        fg.inference(0, 6, checkpoint=str(tmp_path / "ck.npz"),
                     checkpoint_every=2)
    regions = [e for e in prof.events() if e.name == "nsx.chunk"]
    assert len(regions) == 3


def test_device_memory_stats():
    """One entry per card with the JAX function's keys; on a machine
    with no card, one ``cpu`` entry with None values."""
    stats = device_memory_stats()
    assert all(set(s) == {"device", "bytes_in_use", "bytes_limit"}
               for s in stats)
    if not torch.cuda.is_available():
        assert stats == [{"device": "cpu", "bytes_in_use": None,
                          "bytes_limit": None}]
    else:
        assert len(stats) == torch.cuda.device_count()
        assert all(s["bytes_limit"] > 0 for s in stats)
