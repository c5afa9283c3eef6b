"""The frozen generator gives the counts the configuration states."""

import json
import os

import numpy as np
import pytest

from gibbsbench.generators import dp_model

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "gibbsbench", "configs",
                           name + ".json")) as f:
        return json.load(f)


def dp_counts(C, L):
    """Variables, factors, edges, weights of the DP graph: per candidate
    a class and L LFs; 1 + 4L + 4 factors; edges 1 (prior) + 2L + L +
    2L + L (the LF kinds) + 3 + 3 + 2 + 2 (the dependencies)."""
    return C * (1 + L), C * (1 + 4 * L + 4), C * (6 * L + 11), 1 + 4 * L + 4


@pytest.mark.parametrize("C,L", [(37, 24), (50, 10)])
def test_dp_counts_match_formula(C, L):
    cfg = dict(_cfg("snorkel_ehr")["graph"], candidates=C, lfs=L)
    g = dp_model.generate(cfg, 123)
    got = (len(g["variable"]), len(g["factor"]), len(g["fmap"]),
           len(g["weight"]))
    assert got == dp_counts(C, L)
    assert int(g["factor"]["arity"].sum()) == len(g["fmap"]) == g["edges"]
    v = g["variable"]
    assert (v["isEvidence"] == 1).sum() == C * L
    assert set(np.unique(v["cardinality"])) == {2, 3}


def test_config_counts_are_the_formulas():
    c = _cfg("snorkel_ehr")
    assert dp_counts(c["graph"]["candidates"], c["graph"]["lfs"]) == (
        c["counts"]["variables"], c["counts"]["factors"],
        c["counts"]["edges"], c["counts"]["weights"]) == (
        5640175, 22786307, 34969085, 101)


def test_seed_fixes_the_graph():
    cfg = dict(_cfg("snorkel_ehr")["graph"], candidates=40)
    a, b = dp_model.generate(cfg, 2 ** 33 + 1), dp_model.generate(cfg,
                                                                   2 ** 33 + 1)
    c = dp_model.generate(cfg, 2 ** 33 + 2)
    for k in ("weight", "variable", "factor", "fmap"):
        assert (a[k] == b[k]).all()
    assert (a["variable"] != c["variable"]).any()


def test_dp_class_starts_at_majority_vote():
    cfg = dict(_cfg("snorkel_ehr")["graph"], candidates=300)
    g = dp_model.generate(cfg, 5)
    lab, y0 = g["data"]["lab"], g["data"]["y0"]
    ones, zeros = (lab == 1).sum(1), (lab == 0).sum(1)
    clear = ones != zeros
    assert (y0[clear] == (ones > zeros)[clear]).all()
    yv = np.arange(300) * 25
    assert (g["variable"]["initialValue"][yv] == y0).all()

