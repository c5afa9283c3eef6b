"""The roofline's least time is counted from the graph's own counts."""

import numpy as np
import pytest

from gibbsbench import costmodel, peaks
from gibbsbench.importcheck import imports_of
from gibbsbench.records import FACTOR, FMAP, VARIABLE, WEIGHT


def _graph():
    """Three variables (cards 2, 3, 2; the last evidence), factors of
    arity 2 on (0, 1) and arity 1 on (2,), two weights."""
    v = np.zeros(3, VARIABLE)
    v["cardinality"] = (2, 3, 2)
    v["isEvidence"] = (0, 0, 1)
    f = np.zeros(2, FACTOR)
    f["arity"] = (2, 1)
    f["ftv_offset"] = (0, 2)
    fm = np.zeros(3, FMAP)
    fm["vid"] = (0, 1, 2)
    return {"weight": np.zeros(2, WEIGHT), "variable": v, "factor": f,
            "fmap": fm}


def test_inference_cost_by_hand():
    c = costmodel.graph_counts(_graph())
    # sample_evidence off: variables 0 and 1 update; factor 0 is on them
    e = costmodel.epoch_cost(c, "inference", False)
    ops = (2 + 2) * 2 + (2 + 2) * 3 + 4 * (2 + 3)
    nbytes = 8 + 2 * 4 + 3 * 2 + 2 * 1 + 2 * 4 + 2 * 2 * 4
    assert (e["ops"], e["bytes"]) == (ops, nbytes)
    assert e["seconds"] == max(nbytes / peaks.HBM_BYTES_PER_S,
                               ops / peaks.FP32_FLOPS)
    assert e["bound"] == "bytes"
    # sample_evidence on: every variable and factor
    e = costmodel.epoch_cost(c, "inference", True)
    assert e["ops"] == ops + (1 + 2) * 2 + 4 * 2
    assert e["bytes"] == 2 * 8 + 3 * 4 + 3 * 2 + 3 + 2 * 4 + 3 * 2 * 4


def test_learning_counts_two_chains():
    c = costmodel.graph_counts(_graph())
    e = costmodel.epoch_cost(c, "learning", True)
    free = (2 + 2) * 2 + (2 + 2) * 3 + (1 + 2) * 2 + 4 * 7
    clamped = (2 + 2) * 2 + (2 + 2) * 3 + 4 * 5
    assert e["ops"] == free + clamped + 2 * 3
    assert e["bytes"] == (2 * 8 + 3 * 4 + 3 * 2 + 3 + 2 * 4) + 3 + 2 + 2 * 4


def test_reads_only_the_graph():
    """The cost model imports nothing of the program and sees only the
    generator's arrays: a graph dict with nothing else gives the same
    numbers as one with extra keys."""
    assert imports_of(costmodel.__file__) <= {"__future__", "numpy",
                                              "gibbsbench"}
    g = _graph()
    a = costmodel.epoch_cost(costmodel.graph_counts(g), "learning", True)
    g2 = dict(g, tables="anything the program built", data={})
    b = costmodel.epoch_cost(costmodel.graph_counts(g2), "learning", True)
    assert a == b


@pytest.mark.parametrize("phase,se", [("learning", True),
                                      ("inference", False)])
def test_ehr_cost_is_bytes_bound(phase, se):
    from gibbsbench.generators import dp_model
    cfg = {"candidates": 50, "lfs": 24, "propensity": [0.3, 0.9],
           "accuracy": [0.6, 0.9], "coverage_ramp": [0.6, 1.4]}
    e = costmodel.epoch_cost(costmodel.graph_counts(
        dp_model.generate(cfg, 1)), phase, se)
    assert e["bound"] == "bytes" and e["seconds"] > 0
