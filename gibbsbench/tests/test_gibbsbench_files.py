"""BENCHMARK.json keeps to the benchmark's contract, and every
configuration, traffic mix and per-layer metric it names is a file of
its own that the harness finds by that name."""

import importlib
import importlib.util
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gibbsbench")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gibbsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 2 + 14 * n <= 2 + 14 * 24
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + \
        1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, n // 4)


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gibbsbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in BENCH[k])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(cfg):
    with open(os.path.join(ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    for key in ("generator", "reference"):
        sub = "generators" if key == "generator" else "reference"
        importlib.import_module("gibbsbench.%s.%s" % (sub, body[key]))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    from gibbsbench import run
    _, cell, cfg, traffic = run.load_cell(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]}
    assert "setup_s" in e2e and len(e2e) == 2
    ref = importlib.import_module("gibbsbench.reference." + cfg["reference"])
    check = getattr(ref, "check_" + traffic["phase"])
    assert callable(check)
    layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    path = os.path.join(HERE, "metrics", m["name"] + ".py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({}) is None
    assert mod.read({"phase": "nothing"}) is None
