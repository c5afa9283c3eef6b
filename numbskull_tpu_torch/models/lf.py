"""Labeling-function generative model (Snorkel-style).

TPU-framework equivalent of the reference's statistical learning test
model (reference: test_lf_learning.py:22-126): per copy, one latent label
y (boolean query var) and n labeling-function outputs l_j (cardinality-3
evidence vars), tied by DP_GEN_CLASS_PRIOR(y) @ w0 and
DP_GEN_LF_ACCURACY(y, l_j) @ w_{1+j}.

Unlike the reference (which draws data from a hand-written formula that
disagrees with eval_factor's abstain convention), data here is drawn from
the exact joint implied by the factor semantics themselves —
P(y, l) ∝ exp(w0*h_prior(y) + Σ_j w_j*h_acc(y, l_j)) with h_acc(y,l) = 0
if l==2, +1 if y==l, −1 otherwise — so maximum-likelihood weights are
recoverable and the learning test can assert tolerances.
"""

from __future__ import annotations

import itertools

import numpy as np

from numbskull_tpu_torch import types as T


def _h_prior(y: int) -> float:
    return 1.0 if y == 1 else -1.0


def _h_acc(y: int, l: int) -> float:
    if l == 2:
        return 0.0
    return 1.0 if y == l else -1.0


def lf_exact_cdf(prior: float, accuracy) -> tuple[np.ndarray, list]:
    """Exact CDF over all (y, l_1..l_n) states under the factor semantics."""
    n = len(accuracy)
    states = list(itertools.product([0, 1], *[[0, 1, 2]] * n))
    logp = np.array([
        prior * _h_prior(s[0]) +
        sum(accuracy[j] * _h_acc(s[0], s[1 + j]) for j in range(n))
        for s in states])
    z = np.exp(logp - logp.max())
    return np.cumsum(z) / z.sum(), states


def lf_model(prior: float, accuracy, copies: int, seed: int = 0,
             weight_init: float = 1.0, prior_init: float = 0.0):
    """Build `copies` independent LF-model instances with sampled data.

    Accuracy weights start at `weight_init` (default 1.0, like the
    reference test_lf_learning.py:80-83) to break the y -> 1-y
    label-switching symmetry; with a symmetric start the chain may learn
    the globally sign-flipped solution.

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    rng = np.random.default_rng(seed)
    n = len(accuracy)
    cdf, states = lf_exact_cdf(prior, accuracy)

    W = 1 + n
    V = copies * (1 + n)
    F = copies * (1 + n)
    E = copies * (1 + 2 * n)

    weights = T.new_weights(W)
    weights["isFixed"] = False
    weights["initialValue"] = weight_init
    weights["initialValue"][0] = prior_init

    variables = T.new_variables(V)
    factors = T.new_factors(F)
    fmap = T.new_fmap(E)

    for c in range(copies):
        s = states[int(np.searchsorted(cdf, rng.random()))]
        y, lfs = s[0], s[1:]
        vb = c * (1 + n)
        fb = c * (1 + n)
        eb = c * (1 + 2 * n)

        variables["isEvidence"][vb] = 0          # y is a query variable
        variables["initialValue"][vb] = 0
        variables["dataType"][vb] = 0
        variables["cardinality"][vb] = 2
        for j in range(n):
            variables["isEvidence"][vb + 1 + j] = 1
            variables["initialValue"][vb + 1 + j] = lfs[j]
            variables["dataType"][vb + 1 + j] = 0
            variables["cardinality"][vb + 1 + j] = 3

        factors["factorFunction"][fb] = T.FUNC_DP_GEN_CLASS_PRIOR
        factors["weightId"][fb] = 0
        factors["featureValue"][fb] = 1.0
        factors["arity"][fb] = 1
        factors["ftv_offset"][fb] = eb
        fmap["vid"][eb] = vb

        for j in range(n):
            f = fb + 1 + j
            e = eb + 1 + 2 * j
            factors["factorFunction"][f] = T.FUNC_DP_GEN_LF_ACCURACY
            factors["weightId"][f] = 1 + j
            factors["featureValue"][f] = 1.0
            factors["arity"][f] = 2
            factors["ftv_offset"][f] = e
            fmap["vid"][e] = vb          # y
            fmap["vid"][e + 1] = vb + 1 + j  # l_j

    domain_mask = np.zeros(V, np.bool_)
    return weights, variables, factors, fmap, domain_mask, E
