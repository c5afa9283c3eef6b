"""The spouse (KBC) configuration: its generator's counts and seed, the
reference's enumeration against brute force, its checks against the
planted faults at a tiny size, and its per-layer readers off the card."""

import importlib.util
import itertools
import json
import os

import numpy as np
import pytest
import torch

from gibbsbench.generators import kbc_spouse as gen
from gibbsbench.reference import kbc_spouse as ref
from gibbsbench import run
from gibbsbench.tests.helpers import run_tiny, tiny
from gibbsbench.tests.test_gibbsbench_faults import (altered, half_batch,
                                                     unchanged)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gibbsbench")
with open(os.path.join(HERE, "configs", "deepdive_spouse.json")) as f:
    CFG = json.load(f)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
#: the per-layer metrics that each new cell reports
PER_LAYER = {c: {m["name"] for m in BENCH["per_layer"]
                 if c in m["workloads"]}
             for c in ("spouse.learn", "spouse.infer")}
#: the readers this configuration brings
READERS = ("spouse.sum_share", "spouse.partials_per_weight")


def _graph(**kw):
    return dict(CFG["graph"], **dict(gen.TINY, **kw))


@pytest.mark.parametrize("shares", [[0.7, 0.2, 0.1], [0.0, 0.0, 1.0],
                                    [0.5, 0.5, 0.0]])
def test_counts_match_the_formulas(shares):
    """k(k-1) candidates, as many symmetry factors and k(k-1)(k-2)
    one-marriage factors a sentence of k mentions; one ISTRUE factor a
    (candidate, feature), 8 to 60 a candidate; evidence on both
    orderings of 2 % (true) and 10 % (false) of the pairs."""
    cfg = _graph(sentences=200, mention_shares=shares)
    g = gen.generate(cfg, 2 ** 33 + 5)
    ks = g["data"]["k"].astype(np.int64)
    n = np.floor(np.asarray(shares) * 200 + 0.5).astype(int)
    n[-1] = 200 - n[:-1].sum()
    assert np.bincount(ks, minlength=5)[2:].tolist() == n.tolist()
    V, M = int((ks * (ks - 1)).sum()), int((ks * (ks - 1) * (ks - 2)).sum())
    f = g["factor"]
    nf = int((f["factorFunction"] == gen.ISTRUE).sum())
    assert len(g["variable"]) == V
    assert (f["weightId"] == gen.W_SYMMETRY).sum() == V
    assert (f["weightId"] == gen.W_MARRIAGE).sum() == M
    assert len(f) == nf + V + M and g["edges"] == nf + 2 * (V + M)
    assert int(f["arity"].sum()) == len(g["fmap"]) == g["edges"]
    per = np.diff(g["data"]["feat_ptr"])
    assert per.min() >= 8 and per.max() <= 60 and per.sum() == nf
    lab = g["data"]["label"]
    assert (lab == 1).sum() == 2 * int(np.floor(0.02 * V / 2 + 0.5))
    assert (lab == 0).sum() == 2 * int(np.floor(0.10 * V / 2 + 0.5))
    s = gen.sizes(cfg, 2 ** 33 + 5)
    assert (s["variables"], s["factors"], s["edges"], s["weights"]) == (
        V, len(f), len(g["fmap"]), len(g["weight"]))


def test_config_counts_are_the_generators():
    c = CFG["counts"]
    assert gen.sizes(CFG["graph"], CFG["counts_seed"]) == c
    # 280,000, 80,000 and 40,000 sentences of 2, 3 and 4 mentions
    assert c["variables"] == 280000 * 2 + 80000 * 6 + 40000 * 12
    assert c["marriage_factors"] == 80000 * 6 + 40000 * 24
    assert c["weights"] == 1000002 and CFG["reduced"] == []


def test_seed_fixes_the_graph():
    cfg = _graph(sentences=80)
    a, b = gen.generate(cfg, 2 ** 33 + 1), gen.generate(cfg, 2 ** 33 + 1)
    c = gen.generate(cfg, 2 ** 33 + 2)
    for k in ("weight", "variable", "factor", "fmap"):
        assert (a[k] == b[k]).all()
    assert (a["variable"] != c["variable"]).any()


def _brute(g):
    """Marginals of P(x) ~ exp(sum_f w_f f(x)) over every joint state,
    the factors evaluated from their records: ISTRUE x, IMPLY_NATURAL
    1 when body and head are true, else 0."""
    v, f, fm = g["variable"], g["factor"], g["fmap"]
    w = g["weight"]["initialValue"]
    args = [fm["vid"][o:o + a] for o, a in zip(f["ftv_offset"], f["arity"])]
    tot, marg = 0.0, np.zeros(len(v))
    for x in itertools.product((0, 1), repeat=len(v)):
        x = np.asarray(x)
        e = 0.0
        for fn, wid, a in zip(f["factorFunction"], f["weightId"], args):
            if fn == gen.ISTRUE:
                e += w[wid] * (1.0 if x[a[0]] else -1.0)
            else:
                e += w[wid] * float(x[a].all())
        z = np.exp(e)
        tot += z
        marg += z * x
    return marg / tot


def test_enumeration_against_brute_force():
    cfg = _graph(sentences=2, mention_shares=[0.5, 0.5, 0.0],
                 features=[2, 4, 3], feature_weights=20)
    g = gen.generate(cfg, 3)
    p, tau = ref.exact(g["data"], g["data"]["w0"], "cpu")
    np.testing.assert_allclose(p.numpy(), _brute(g), rtol=1e-10, atol=1e-12)
    assert (tau.numpy() >= 1).all()


def test_autocorrelation_time_of_a_pair():
    """A lone pair (x, y), drawn x then y: the chain of x has
    K(a, a') = sum_b P(b | a) P(a' | b), whose asymptotic variance is
    q (1 + lambda) / (1 - lambda), lambda its second eigenvalue."""
    P = torch.tensor([[0.4, 0.1, 0.2, 0.3]], dtype=torch.float64)
    tau = ref._two_block_tau(P, np.array([True, False]), "cpu")
    J = P.reshape(2, 2).T            # J[a, b], state a + 2b
    for i, joint in enumerate((J, J.T)):
        K = (joint / joint.sum(1, keepdim=True)) @ \
            (joint / joint.sum(0, keepdim=True)).T
        lam = float(torch.linalg.eigvals(K).real.min())
        assert float(tau[0, i]) == pytest.approx((1 + lam) / (1 - lam))


@pytest.mark.parametrize("cell,fault,check", [
    ("spouse.learn", unchanged, "unmoved"),
    ("spouse.learn", half_batch, "unmoved"),
    ("spouse.learn", altered, "fixed_moved"),
    ("spouse.infer", unchanged, "chi2_excess"),
    ("spouse.infer", half_batch, "chi2_excess"),
    ("spouse.infer", altered, "chi2_excess"),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_fails_its_check(cell, fault, check):
    """Inference runs 200 epochs: at 5 one answer altered is within the
    spread of a sound run's."""
    bench, cell, cfg, traffic = tiny(cell)
    cfg["inference"]["n_inference_epoch"] = 200
    with fault():
        res = run.run_cell(bench, cell, cfg, traffic, 2 ** 33 + 7, 0.0,
                           False, "cpu")
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("first,last,share", [
    ("moved", "back", 0.0),      # came back to w0 at the last call: sound
    ("back", "moved", 0.0),
    ("back", "back", 1.0),       # never moved
], ids=lambda x: str(x))
def test_unmoved_counts_only_weights_at_their_start_after_every_call(
        first, last, share):
    """One live weight, at its initial float32 value after the first or
    the last call or both: only both count as unmoved."""
    g = gen.generate(_graph(sentences=40), 2 ** 33 + 3)
    data = g["data"]
    w0 = np.asarray(data["w0"], np.float64)
    fixed = np.asarray(data["fixed"], bool)
    ev = np.repeat(np.asarray(data["evidence"], bool),
                   np.diff(np.asarray(data["feat_ptr"])))
    has_ev = np.zeros(len(w0), bool)
    has_ev[np.asarray(data["feat_wid"])[ev]] = True
    live = ~fixed & has_ev & (np.abs(w0) >= 1e-3)
    i = int(np.flatnonzero(live)[0])
    moved = w0.copy()
    moved[~fixed] += 0.25
    ws = {"moved": moved}
    back = moved.copy()
    back[i] = float(np.float32(w0[i]))
    ws["back"] = back
    r = ref.learn_numbers(CFG, data, ws[first], ws[last], moved, moved,
                          min_factors=1)
    assert r["unmoved"] == share / live.sum()


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_off_the_card(name):
    spec = importlib.util.spec_from_file_location(
        "reader", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for phase in ("learning", "inference"):
        assert mod.read({"phase": phase}) is None
        assert mod.read({"phase": phase, "trace": {
            "busy_s": None, "window_s": 1.0, "device_ops": []}}) is None


@pytest.mark.parametrize("cell", ["spouse.learn", "spouse.infer"])
def test_tiny_traced_run_reports_no_device_metric(cell):
    """On the CPU a traced run's slice has no device interval: of the
    cell's per-layer readers only its launch counter reads (0 launches:
    the plain versions). The checks' limits are set at the cells' size: five
    learning epochs on 240 sentences leave the weights' gaps to noise,
    so there only the exact ones are asserted."""
    res = run_tiny(cell, trace=True)
    c = res["checks"]
    assert all(c[k]["value"] == 0 for k in c if c[k]["limit"] == 0), c
    assert res["correct"] or cell == "spouse.learn", c
    got = set(res["metrics"]) & PER_LAYER[cell]
    assert got == ({"sweep.launches_per_epoch"} if cell == "spouse.infer"
                   else {"learn.launches_per_epoch"})


@pytest.mark.parametrize("cell", ["spouse.learn", "spouse.infer"])
def test_dry_run_loads_no_jax(cell):
    """A tiny run of each new cell in a fresh process leaves nothing
    forbidden in ``sys.modules`` (``gibbsbench.importcheck``)."""
    import subprocess
    import sys
    code = ("import sys; from gibbsbench.tests.helpers import run_tiny; "
            "from gibbsbench.importcheck import loaded_forbidden; "
            "run_tiny(%r); print(loaded_forbidden(sys.modules))" % cell)
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
