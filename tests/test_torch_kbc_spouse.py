"""DeepDive's spouse graph (``gibbsbench/generators/kbc_spouse.py``:
boolean candidates, ISTRUE feature factors on Zipf-tied weights, IMPLY
rules on fixed weights) through the port on the CPU, against the plain
reference of ``gibbsbench/reference/kbc_spouse.py``: the exact marginals
of each sentence by enumeration, and its own dual-chain learner.

The graph is cut to 40 sentences (152 candidates, 3,969 feature factors)
and 300 feature weights, and seeded, so that every number below is
fixed; each bound says what it allows for.
"""

import os

import numpy as np

from gibbsbench.generators import kbc_spouse as gen
from gibbsbench.reference import kbc_spouse as ref
from numbskull_tpu_torch import dataloading
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.numbskull import NumbSkull
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine

from _torch_threads import cap_threads

cap_threads()

#: the spouse graph's shape (2 to 4 mentions a sentence, 8 to 60
#: features a candidate, Zipf(1) feature weights, the rules' fixed
#: weights, 2 % / 10 % evidence), cut to 40 sentences and 300 weights
GRAPH = {"sentences": 40, "mention_shares": [0.7, 0.2, 0.1],
         "features": [8, 60, 25], "feature_weights": 300, "zipf_s": 1.0,
         "weight_sd": 0.5, "rule_weights": [3.0, -1.0],
         "evidence": [0.02, 0.1]}
#: upstream numbskull's CLI defaults, as the port keeps them; the
#: learning checks compare the weights of 2 % of the feature factors or
#: more (80 factors; the 8 most used)
CFG = {"learning": {"stepsize": 0.01, "decay": 0.95, "reg_param": 0.01,
                    "regularization": 2, "learn_non_evidence": False},
       "check": {"min_factor_share": 0.02}}
#: chi2_excess of 600 epochs' marginals against the exact ones, each
#: variable's draws counted by its autocorrelation time: the reference's
#: own chains read 0.002-0.90 on this graph (12 seeds; a few variables
#: of small variance make the tail), a variable never drawn or an answer
#: altered reads in the tens to thousands (gibbsbench's fault tests)
CHI2_BOUND = 1.5


def _graph(seed=2 ** 33 + 11):
    return gen.generate(GRAPH, seed)


def _load(g, **kw):
    ns = NumbSkull(quiet=True, device="cpu", seed=5, **kw)
    ns.loadFactorGraph(g["weight"], g["variable"], g["factor"], g["fmap"],
                       g["domain_mask"], g["edges"])
    return ns, ns.factorGraphs[0]


def _chi2(counts, n, data, w):
    """``check_inference``'s number for tallies ``counts`` after ``n``
    epochs, against the exact marginals at weights ``w``."""
    return ref.check_inference(CFG, dict(data, w0=w),
                               {"epochs": n, "count": counts}, 0,
                               "cpu")["chi2_excess"]


def test_inference_marginals_against_the_enumeration():
    """600 epochs with evidence sampled, on the kernels' engine with no
    fallback: every candidate's marginal against the exact one."""
    g = _graph()
    metrics.reset()
    ns, fg = _load(g, n_inference_epoch=600, sample_evidence=True,
                   burn_in=50)
    ns.inference(out=False)
    assert isinstance(fg.engine(True), ItemGridEngine)
    assert metrics.snapshot()["counters"].get("engine.fallbacks", 0) == 0
    counts = fg.state.count.numpy()
    assert _chi2(counts, 600, g["data"], g["data"]["w0"]) < CHI2_BOUND


def _learn_numbers(g, ws, values_evid, epochs):
    """``check_learning``'s numbers for the weights after each of
    ``len(ws)`` calls of ``epochs`` epochs, against the reference
    learner's after as many calls."""
    cfg = dict(CFG, learning=dict(CFG["learning"], n_learning_epoch=epochs))
    return ref.check_learning(cfg, g["data"], {
        "weights": ws, "values_evid": values_evid}, 7, "cpu")


def test_learned_weights_against_the_reference_learner():
    """Two 40-epoch learning calls with the CLI's defaults (step 0.01,
    decay 0.95, L2 0.01): the weights against the reference learner's
    after as many calls, as ``check_learning`` compares them. Two sound
    runs of the reference differ here by w_gap 0.037-0.102 and w_l2
    0.034-0.072 (8 seeds); the bounds are about two and a half times
    the largest."""
    g = _graph()
    ns, fg = _load(g, n_learning_epoch=40)
    ws = []
    for _ in range(2):
        ns.learning(out=False)
        ws.append(fg.getWeights().astype(np.float64))
    r = _learn_numbers(g, ws, fg.state.var_value_evid.numpy(), 40)
    assert r["w_gap"] < 0.25 and r["w_l2"] < 0.2, r
    assert r["unmoved"] == 0 and r["fixed_moved"] == 0, r
    assert r["evidence_moved"] == 0, r


def test_fixed_rule_weights_stay_put():
    """The symmetry (3.0) and one-marriage (-1.0) weights are fixed: the
    IMPLY items of evidence rows carry gradients, and the weights keep
    their values exactly; marked learnable, the same call moves them."""
    g = _graph()
    ns, fg = _load(g, n_learning_epoch=20)
    ns.learning(out=False)
    assert fg.getWeights()[:2].tolist() == [3.0, -1.0]
    g["weight"]["isFixed"][:2] = False
    ns, fg = _load(g, n_learning_epoch=20)
    ns.learning(out=False)
    assert (fg.getWeights()[:2] != [3.0, -1.0]).all()


def test_cli_on_deepdive_files(tmp_path):
    """The graph written as DeepDive's graph.* files and run through the
    CLI, ``-l 40 -i 600``: the dumped weights against the reference
    learner's after one call (bounds as above), and the dumped marginals
    against the exact ones at the dumped weights."""
    g = _graph(2 ** 33 + 12)
    src, out = str(tmp_path / "graph"), str(tmp_path / "out")
    dataloading.write_factor_graph_files(src, g["weight"], g["variable"],
                                         g["factor"], g["fmap"])
    port_cli.main([src, "-l", "40", "-i", "600", "-b", "50", "-o", out,
                   "--device", "cpu", "-q"])
    rows = np.loadtxt(os.path.join(out, "inference_result.out.weights.text"),
                      ndmin=2)
    w = np.zeros(len(g["weight"]))
    w[rows[:, 0].astype(np.int64)] = rows[:, 1]
    # the CLI dumps no clamped chain: the initial values stand in for
    # it, and evidence_moved is not asserted here
    r = _learn_numbers(g, [w], g["data"]["x0"], 40)
    assert r["w_gap"] < 0.25 and r["w_l2"] < 0.2, r
    assert r["fixed_moved"] == 0, r
    rows = np.loadtxt(os.path.join(out, "inference_result.out.text"),
                      ndmin=2)
    vid, val, prob = (rows[:, 0].astype(np.int64),
                      rows[:, 1].astype(np.int64), rows[:, 2])
    m = np.zeros(len(g["variable"]))
    m[vid[val == 1]] = prob[val == 1]
    assert len(np.unique(vid)) == len(g["variable"])
    counts = np.stack([600 - m * 600, m * 600], 1)
    assert _chi2(counts, 600, g["data"], w) < CHI2_BOUND
