"""DeepDive's spouse example (a knowledge-base construction graph) as a
factor graph, generated from a seed.

The application (HazyResearch/deepdive ``examples/spouse/app.ddlog``)
reads news sentences, takes every ordered pair of person mentions of a
sentence with fewer than five people as a candidate, and asks for each
whether the two are married: one boolean query variable ``has_spouse``
a candidate. Its rules, as grounded here:

- features: ``@weight(f) has_spouse(p1, p2) :- spouse_feature(p1, p2,
  f)``: one ISTRUE factor of arity 1 a (candidate, feature), its weight
  tied to the feature; feature ids are Zipf-distributed over
  ``feature_weights`` learnable weights, as text features are;
- symmetry: ``@weight(3.0) has_spouse(p1, p2) => has_spouse(p2, p1)``:
  one IMPLY factor (body, head) a candidate, on fixed weight 0;
- one marriage: ``@weight(-1) has_spouse(p1, p2) => has_spouse(p1,
  p3)``: one IMPLY factor for every ordered triple of distinct mentions
  of a sentence, on fixed weight 1. The rule's body, as recalled, has
  no ``p3 != p2``, so its join also gives the k(k-1) groundings with
  p3 = p2; they are left out (the configuration's ``assumed`` says so):
  each would be ``x => x`` on one candidate, which says nothing of a
  second marriage and, under the semantics below, only adds -1 x to
  that candidate's energy.

``=>`` grounds to ``FUNC_IMPLY_NATURAL`` (code 0), which upstream
numbskull evaluates, and the port with it, as 1 when body and head are
both true and 0 otherwise (its search for a false body runs over the
head too).

A sentence with k mentions gives k(k-1) candidates (in (i, j) order,
i != j) and k(k-1)(k-2) one-marriage factors. Distant supervision labels
unordered pairs, so both orderings of a labelled pair are evidence with
the same value; the other candidates start at a value drawn from the
seed. Everything is drawn with numpy from one ``default_rng(seed)``, in
whole arrays.
"""

from __future__ import annotations

import numpy as np

from gibbsbench.records import FACTOR, FMAP, VARIABLE, WEIGHT

IMPLY_NATURAL, ISTRUE = 0, 4
#: weight ids of the two rules with fixed weights; features follow
W_SYMMETRY, W_MARRIAGE, W_FEATURE0 = 0, 1, 2

#: the graph keys that cut a configuration to the size of a CPU test
TINY = {"sentences": 240, "feature_weights": 2000}


def layout(k: int):
    """The candidates of one sentence with ``k`` mentions, as
    (pairs (k(k-1), 2) in (i, j) order, the index of each pair's reverse,
    the one-marriage factors (k(k-1)(k-2), 2) as (body, head) candidate
    indices: (i, j) => (i, l), l not in {i, j})."""
    pairs = np.array([(i, j) for i in range(k) for j in range(k) if i != j],
                     np.int64).reshape(-1, 2)
    index = {tuple(p): n for n, p in enumerate(pairs)}
    rev = np.array([index[(j, i)] for i, j in pairs], np.int64)
    mar = np.array([(index[(i, j)], index[(i, l)]) for i, j in pairs
                    for l in range(k) if l not in (i, j)],
                   np.int64).reshape(-1, 2)
    return pairs, rev, mar


def zipf_ranks(rng, n: int, size: int, s: float) -> np.ndarray:
    """``size`` draws of ranks 0..n-1 with P(r) proportional to
    (r + 1)^-s (inverse of the exact cumulative distribution)."""
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -float(s))
    u = rng.random(size) * cdf[-1]
    return np.minimum(np.searchsorted(cdf, u, side="right"), n - 1)


def _draw_sizes(cfg: dict, rng):
    """Every sentence's mention count (in corpus order) and every
    candidate's feature count, the generator's first draws."""
    S = int(cfg["sentences"])
    shares = np.asarray(cfg["mention_shares"], np.float64)
    n_k = np.floor(shares * S + 0.5).astype(np.int64)
    n_k[-1] = S - n_k[:-1].sum()
    ks = np.repeat(np.arange(2, 2 + len(n_k)), n_k)[rng.permutation(S)]
    V = int((ks * (ks - 1)).sum())
    # lo + Binomial(hi - lo, p), p ~ Beta(2, b), with the mean given
    lo, hi, mean = (int(x) for x in cfg["features"])
    b = 2.0 * (hi - mean) / (mean - lo)
    return ks, lo + rng.binomial(hi - lo, rng.beta(2.0, b, V))


def sizes(cfg: dict, seed: int) -> dict:
    """The graph's counts from ``seed`` (those of :func:`generate`),
    without building it."""
    ks, n_feat = _draw_sizes(cfg, np.random.default_rng(int(seed)))
    V = len(n_feat)
    M = int((ks * (ks - 1) * (ks - 2)).sum())
    NFF = int(n_feat.sum())
    return {"variables": V, "factors": NFF + V + M,
            "edges": NFF + 2 * (V + M),
            "weights": W_FEATURE0 + int(cfg["feature_weights"]),
            "feature_factors": NFF, "symmetry_factors": V,
            "marriage_factors": M}


def generate(cfg: dict, seed: int) -> dict:
    """The graph of configuration ``cfg`` (its ``sentences``,
    ``mention_shares`` for k = 2, 3, 4, ``features`` (least, most,
    mean a candidate), ``feature_weights``, ``zipf_s``, ``weight_sd``,
    ``rule_weights`` (symmetry, one marriage) and ``evidence`` (shares
    of candidates labelled true, false)) from ``seed``: the program's
    input arrays, and under ``data`` what the plain reference reads."""
    rng = np.random.default_rng(int(seed))
    ks, n_feat = _draw_sizes(cfg, rng)
    n_cand = ks * (ks - 1)
    cand0 = np.concatenate(([0], np.cumsum(n_cand)))
    V = int(cand0[-1])

    # symmetry and one-marriage factors, sentence by sentence in order
    sym = np.zeros((V, 2), np.int64)
    mar_parts, mar_order = [], []
    for k in range(2, int(ks.max(initial=1)) + 1):
        sel = np.flatnonzero(ks == k)
        if not len(sel):
            continue
        _, rev, mar = layout(k)
        base = cand0[sel][:, None]
        idx = (base + np.arange(k * (k - 1))).ravel()
        sym[idx, 0] = idx
        sym[idx, 1] = (base + rev).ravel()
        mar_parts.append((base[:, :, None] + mar[None]).reshape(-1, 2))
        mar_order.append(np.repeat(sel, len(mar)))
    if mar_parts:
        order = np.argsort(np.concatenate(mar_order), kind="stable")
        marriage = np.concatenate(mar_parts)[order]
    else:
        marriage = np.zeros((0, 2), np.int64)

    # feature ids Zipf over the weights
    NF = int(cfg["feature_weights"])
    feat_ptr = np.concatenate(([0], np.cumsum(n_feat)))
    feat_wid = (W_FEATURE0 + zipf_ranks(rng, NF, int(feat_ptr[-1]),
                                        cfg["zipf_s"])).astype(np.int32)

    w = np.zeros(W_FEATURE0 + NF, WEIGHT)
    w["initialValue"][:W_FEATURE0] = cfg["rule_weights"]
    w["isFixed"][:W_FEATURE0] = True
    w["initialValue"][W_FEATURE0:] = rng.normal(0.0, cfg["weight_sd"], NF)

    # evidence on unordered pairs: both orderings alike
    first = np.flatnonzero(sym[:, 0] < sym[:, 1])
    n_true, n_false = (int(np.floor(s * len(first) + 0.5))
                       for s in cfg["evidence"])
    pick = first[rng.permutation(len(first))[:n_true + n_false]]
    label = np.full(V, -1, np.int8)
    label[pick[:n_true]] = 1
    label[pick[n_true:]] = 0
    label[sym[pick, 1]] = label[pick]
    evid = label >= 0
    x0 = rng.integers(0, 2, V).astype(np.int8)
    x0[evid] = label[evid]

    v = np.zeros(V, VARIABLE)
    v["isEvidence"] = evid
    v["initialValue"] = x0
    v["cardinality"] = 2

    NFF, NS, NM = int(feat_ptr[-1]), V, len(marriage)
    F = NFF + NS + NM
    f = np.zeros(F, FACTOR)
    f["factorFunction"][:NFF] = ISTRUE
    f["factorFunction"][NFF:] = IMPLY_NATURAL
    f["weightId"][:NFF] = feat_wid
    f["weightId"][NFF:NFF + NS] = W_SYMMETRY
    f["weightId"][NFF + NS:] = W_MARRIAGE
    f["featureValue"] = 1.0
    f["arity"][:NFF] = 1
    f["arity"][NFF:] = 2
    f["ftv_offset"][:NFF] = np.arange(NFF)
    f["ftv_offset"][NFF:] = NFF + 2 * np.arange(NS + NM)
    fm = np.zeros(NFF + 2 * (NS + NM), FMAP)
    fm["vid"][:NFF] = np.repeat(np.arange(V), n_feat)
    fm["vid"][NFF:NFF + 2 * NS] = sym.ravel()
    fm["vid"][NFF + 2 * NS:] = marriage.ravel()
    return {"weight": w, "variable": v, "factor": f, "fmap": fm,
            "domain_mask": np.zeros(V, np.bool_), "edges": len(fm),
            "data": {"k": ks.astype(np.int8), "cand0": cand0,
                     "feat_ptr": feat_ptr, "feat_wid": feat_wid,
                     "w0": w["initialValue"].copy(),
                     "fixed": w["isFixed"].copy(), "evidence": evid,
                     "label": label, "x0": x0}}
