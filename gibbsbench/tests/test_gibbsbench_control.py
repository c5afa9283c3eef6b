"""The control, the plain reference put in the program's place in
bfloat16 (the precision below the configurations' float32), fails a
number of each cell's check, at a size a test can hold; on the chip
``python -m gibbsbench.control`` reads it at the cells' own size."""

import json
import os

import pytest

from gibbsbench.control import readings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def limits(name):
    with open(os.path.join(ROOT, "gibbsbench", "configs",
                           name + ".json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("seed", [11, 12])
def test_learning_control_and_half_batch_fail(seed):
    r = readings("snorkel_ehr", "learning", seed, "cpu",
                 graph={"candidates": 4512})
    lim = limits("snorkel_ehr")
    for bad in ("bf16", "half_batch", "unchanged"):
        assert r[bad]["w_gap"] > lim["w_gap"], r
    assert r["sound"]["w_gap"] < lim["w_gap"], r


def test_dp_inference_control_fails():
    r = readings("snorkel_ehr", "inference", 5, "cpu", epochs=20000,
                 graph={"candidates": 11280})
    lim = limits("snorkel_ehr")["chi2_excess"]
    assert r["bf16"]["chi2_excess"] > lim > r["sound"]["chi2_excess"], r

