"""Snorkel's generative model (data programming) as a DeepDive factor
graph, generated from a seed.

A frozen copy of ``chip_smoke.dp_graph`` (the draws in the same order),
with two changes that the configuration lists under ``assumed``:

- each LF's firing propensity drifts along the candidates, from
  ``coverage_ramp[0]`` to ``coverage_ramp[1]`` times its base propensity
  (candidates in document order, and the documents of a corpus differ in
  how often the LFs fire);
- each latent class starts at the majority vote of its LFs (ties from
  the seed), so that both of learning's chains start in the modes the
  data put them in, whatever order the sampler visits colours in.

Per candidate: a latent boolean class y (query) and ``lfs`` LF outputs
(cardinality 3, 2 = abstain, evidence); factors DP_GEN_CLASS_PRIOR(y),
per LF LF_ACCURACY(y, l), LF_PROPENSITY(l), LF_CLASS_PROPENSITY(y, l)
and LF_PRIOR(l), then DEP_FIXING(y, l_a, l_b), DEP_REINFORCING(y, l_a,
l_b), DEP_EXCLUSIVE(l_a, l_b) and DEP_SIMILAR(l_a, l_b) on the LF pairs
(0, 1), (2, 3), (4, 5), (6, 7). One weight per (factor kind, LF) and one
per dependency; weights are shared by all candidates.
"""

from __future__ import annotations

import numpy as np

from gibbsbench.records import FACTOR, FMAP, FUNC, VARIABLE, WEIGHT

DYADIC = (-1.0, -0.75, -0.5, -0.25, -0.125, 0.125, 0.25, 0.5, 0.75, 1.0)
LF_KINDS = ("DP_GEN_LF_ACCURACY", "DP_GEN_LF_PROPENSITY",
            "DP_GEN_LF_CLASS_PROPENSITY", "DP_GEN_LF_PRIOR")
DEP_KINDS = ("DP_GEN_DEP_FIXING", "DP_GEN_DEP_REINFORCING",
             "DP_GEN_DEP_EXCLUSIVE", "DP_GEN_DEP_SIMILAR")

#: the graph keys that cut a configuration to the size of a CPU test
TINY = {"candidates": 120}


def generate(cfg: dict, seed: int) -> dict:
    """The graph of configuration ``cfg`` (its ``candidates``, ``lfs``,
    ``propensity``, ``accuracy`` and ``coverage_ramp``) from ``seed``:
    the program's input arrays, and under ``data`` what the plain
    reference reads (LF outputs (C, L), initial classes, initial
    weights, the dependency pairs)."""
    rng = np.random.default_rng(seed)
    C, L = int(cfg["candidates"]), int(cfg["lfs"])
    y_true = rng.integers(0, 2, C)
    prop = rng.uniform(*cfg["propensity"], L)
    acc = rng.uniform(*cfg["accuracy"], L)
    ramp = np.linspace(*cfg["coverage_ramp"], C)
    fires = rng.random((C, L)) < np.clip(prop[None, :] * ramp[:, None],
                                         0.05, 0.95)
    right = rng.random((C, L)) < acc
    lab = np.where(fires, np.where(right, y_true[:, None],
                                   1 - y_true[:, None]), 2).astype(np.int8)
    pairs = [((2 * k) % L, (2 * k + 1) % L) for k in range(4)]
    nw = 1 + 4 * L + 4
    w = np.zeros(nw, WEIGHT)
    w["initialValue"] = rng.choice(DYADIC, nw) / 2
    w["initialValue"][1:1 + L] = 1.0
    ones, zeros = (lab == 1).sum(1), (lab == 0).sum(1)
    y0 = np.where(ones == zeros, rng.integers(0, 2, C),
                  ones > zeros).astype(np.int8)

    n = C * (1 + L)
    v = np.zeros(n, VARIABLE)
    yv = np.arange(C, dtype=np.int64) * (1 + L)
    lv = yv[:, None] + 1 + np.arange(L)
    v["cardinality"] = 3
    v["cardinality"][yv] = 2
    v["isEvidence"] = 1
    v["isEvidence"][yv] = 0
    v["initialValue"][lv.ravel()] = lab.ravel()
    v["initialValue"][yv] = y0

    kinds = [("DP_GEN_CLASS_PRIOR", [yv], np.zeros(1, np.int64))]
    for k, name in enumerate(LF_KINDS):
        two = name in ("DP_GEN_LF_ACCURACY", "DP_GEN_LF_CLASS_PROPENSITY")
        args = [np.repeat(yv, L), lv.ravel()] if two else [lv.ravel()]
        kinds.append((name, args, np.tile(1 + k * L + np.arange(L), C)))
    for k, (name, (a, b)) in enumerate(zip(DEP_KINDS, pairs)):
        args = [lv[:, a], lv[:, b]]
        if name in ("DP_GEN_DEP_FIXING", "DP_GEN_DEP_REINFORCING"):
            args = [yv] + args
        kinds.append((name, args, np.full(C, 1 + 4 * L + k)))
    nf = sum(len(a[0]) for _, a, _ in kinds)
    f = np.zeros(nf, FACTOR)
    fm = np.zeros(sum(len(a[0]) * len(a) for _, a, _ in kinds), FMAP)
    i = e = 0
    for name, args, wid in kinds:
        m, a = len(args[0]), len(args)
        f["factorFunction"][i:i + m] = FUNC[name]
        f["weightId"][i:i + m] = np.broadcast_to(wid, (m,))
        f["arity"][i:i + m] = a
        f["ftv_offset"][i:i + m] = e + a * np.arange(m)
        fm["vid"][e:e + a * m] = np.stack(args, axis=1).ravel()
        i, e = i + m, e + a * m
    f["featureValue"] = 1.0
    return {"weight": w, "variable": v, "factor": f, "fmap": fm,
            "domain_mask": np.zeros(n, np.bool_), "edges": len(fm),
            "data": {"lab": lab, "y0": y0, "w0": w["initialValue"].copy(),
                     "pairs": pairs}}
