"""Scalar reference-semantics oracle (host-side, tests only).

A tiny, slow, obviously-correct implementation of the reference's factor
evaluation and potential semantics (reference: numbskull/inference.py:55-413),
used by the test suite to validate the vectorized TPU kernels and to compute
exact joint distributions on small graphs by brute-force enumeration.

This is NOT part of the compute path.

Known deviations from the reference (intentional bug fixes, flagged in
tests):

* IMPLY_MLN / IMPLY_NATURAL_CAT / IMPLY_MLN_CAT read the head variable's
  value through ``var_value[fmap[l]['vid']]``; the reference indexes
  ``var_value[l]`` with the fmap *slot index* (reference:
  numbskull/inference.py:242-243,276-277,291-292), which is out of the
  variable id space for any non-trivial graph. We implement the clearly
  intended semantics.
"""

from __future__ import annotations

import math

import numpy as np

from numbskull_tpu_torch.types import (
    FUNC_NOOP, FUNC_IMPLY_NATURAL, FUNC_OR, FUNC_AND, FUNC_EQUAL,
    FUNC_ISTRUE, FUNC_LINEAR, FUNC_RATIO, FUNC_LOGICAL, FUNC_IMPLY_MLN,
    FUNC_AND_CAT, FUNC_OR_CAT, FUNC_EQUAL_CAT_CONST, FUNC_IMPLY_NATURAL_CAT,
    FUNC_IMPLY_MLN_CAT, FUNC_DP_GEN_CLASS_PRIOR, FUNC_DP_GEN_LF_PRIOR,
    FUNC_DP_GEN_LF_PROPENSITY, FUNC_DP_GEN_LF_ACCURACY,
    FUNC_DP_GEN_LF_CLASS_PROPENSITY, FUNC_DP_GEN_DEP_FIXING,
    FUNC_DP_GEN_DEP_REINFORCING, FUNC_DP_GEN_DEP_EXCLUSIVE,
    FUNC_DP_GEN_DEP_SIMILAR, FUNC_UFO,
)


def eval_factor(factor_id: int, var_samp: int, value: int,
                variables: np.ndarray, factors: np.ndarray,
                fmap: np.ndarray, var_value: np.ndarray) -> float:
    """Evaluate one factor with variable `var_samp` hypothetically at `value`.

    Scalar oracle for the 25 factor functions.
    """
    fac = factors[factor_id]
    start = int(fac["ftv_offset"])
    arity = int(fac["arity"])
    ftype = int(fac["factorFunction"])

    def val(pos: int) -> int:
        """Value of the arg at `pos`, substituting the hypothetical."""
        vid = int(fmap[start + pos]["vid"])
        return int(value) if vid == var_samp else int(var_value[vid])

    def eq(pos: int) -> int:
        return int(fmap[start + pos]["dense_equal_to"])

    def card(pos: int) -> int:
        return int(variables[int(fmap[start + pos]["vid"])]["cardinality"])

    if ftype == FUNC_NOOP:
        return 0.0
    if ftype == FUNC_IMPLY_NATURAL:
        if any(val(p) == 0 for p in range(arity)):
            return 0.0
        return 1.0 if val(arity - 1) else -1.0
    if ftype == FUNC_OR:
        return 1.0 if any(val(p) == 1 for p in range(arity)) else -1.0
    if ftype == FUNC_EQUAL:
        v0 = val(0)
        return -1.0 if any(val(p) != v0 for p in range(1, arity)) else 1.0
    if ftype in (FUNC_AND, FUNC_ISTRUE):
        return -1.0 if any(val(p) == 0 for p in range(arity)) else 1.0
    if ftype == FUNC_LINEAR:
        head = val(arity - 1)
        return float(sum(val(p) == head for p in range(arity - 1)))
    if ftype == FUNC_RATIO:
        head = val(arity - 1)
        return math.log(1 + sum(val(p) == head for p in range(arity - 1)))
    if ftype == FUNC_LOGICAL:
        head = val(arity - 1)
        return 1.0 if any(val(p) == head for p in range(arity - 1)) else 0.0
    if ftype == FUNC_IMPLY_MLN:
        if any(val(p) == 0 for p in range(arity - 1)):
            return 1.0
        return 1.0 if val(arity - 1) else 0.0
    if ftype in (FUNC_AND_CAT, FUNC_EQUAL_CAT_CONST):
        return 0.0 if any(val(p) != eq(p) for p in range(arity)) else 1.0
    if ftype == FUNC_OR_CAT:
        return 1.0 if any(val(p) == eq(p) for p in range(arity)) else -1.0
    if ftype == FUNC_IMPLY_NATURAL_CAT:
        if any(val(p) != eq(p) for p in range(arity - 1)):
            return 0.0
        return 1.0 if val(arity - 1) == eq(arity - 1) else -1.0
    if ftype == FUNC_IMPLY_MLN_CAT:
        if any(val(p) != eq(p) for p in range(arity - 1)):
            return 1.0
        return 1.0 if val(arity - 1) == eq(arity - 1) else 0.0
    if ftype == FUNC_DP_GEN_CLASS_PRIOR:
        return 1.0 if val(0) == 1 else -1.0
    if ftype == FUNC_DP_GEN_LF_PRIOR:
        l = val(0)
        return -1.0 if l == 2 else (0.0 if l == 0 else 1.0)
    if ftype == FUNC_DP_GEN_LF_PROPENSITY:
        return 0.0 if val(0) == card(0) - 1 else 1.0
    if ftype == FUNC_DP_GEN_LF_ACCURACY:
        y, l = val(0), val(1)
        if l == card(1) - 1:
            return 0.0
        return 1.0 if y == l else -1.0
    if ftype == FUNC_DP_GEN_LF_CLASS_PROPENSITY:
        y, l = val(0), val(1)
        if l == card(1) - 1:
            return 0.0
        return 1.0 if y == 1 else -1.0
    if ftype == FUNC_DP_GEN_DEP_FIXING:
        y, l1, l2 = val(0), val(1), val(2)
        if l1 == card(1) - 1:
            return -1.0 if l2 != 1 else 0.0
        if l1 == 0 and l2 == 1 and y == 1:
            return 1.0
        if l1 == 1 and l2 == 0 and y == 0:
            return 1.0
        return 0.0
    if ftype == FUNC_DP_GEN_DEP_REINFORCING:
        y, l1, l2 = val(0), val(1), val(2)
        if l1 == card(1) - 1:
            return -1.0 if l2 != 1 else 0.0
        if l1 == 0 and l2 == 0 and y == 0:
            return 1.0
        if l1 == 1 and l2 == 1 and y == 1:
            return 1.0
        return 0.0
    if ftype == FUNC_DP_GEN_DEP_EXCLUSIVE:
        l1, l2 = val(0), val(1)
        abstain = card(0) - 1
        return 0.0 if (l1 == abstain or l2 == abstain) else -1.0
    if ftype == FUNC_DP_GEN_DEP_SIMILAR:
        return 1.0 if val(0) == val(1) else 0.0
    if ftype == FUNC_UFO:
        v = val(0)
        if v == 0:
            return 0.0
        return float(val(v - 1))
    raise NotImplementedError("factor function %d" % ftype)


def slot_factors(variables, factors, fmap, vid: int, value: int,
                 factors_to_skip=()):
    """Factor ids attached to the (variable, value) adjacency slot.

    Mirrors compute_var_map semantics (reference:
    numbskull/dataloading.py:16-81): dataType==0 variables use a single
    slot; dataType==1 use the slot for dense value `value`; duplicate
    (slot, factor) pairs are collapsed.
    """
    skip = set(int(s) for s in factors_to_skip)
    out = set()
    for fid in range(len(factors)):
        if fid in skip:
            continue
        fac = factors[fid]
        for p in range(int(fac["arity"])):
            ftv = fmap[int(fac["ftv_offset"]) + p]
            if int(ftv["vid"]) != vid:
                continue
            if variables[vid]["dataType"] == 0:
                out.add(fid)
            elif int(ftv["dense_equal_to"]) == value:
                out.add(fid)
    return sorted(out)


def potential(variables, factors, fmap, weight_value, vid: int, value: int,
              var_value, factors_to_skip=()) -> float:
    """Unnormalized log-potential of variable `vid` at `value`.

    Reference: numbskull/inference.py:55-71 (sum over the slot's factors of
    weight * eval_factor; featureValue is NOT used during inference).
    """
    p = 0.0
    for fid in slot_factors(variables, factors, fmap, vid, value,
                            factors_to_skip):
        p += float(weight_value[int(factors[fid]["weightId"])]) * \
            eval_factor(fid, vid, value, variables, factors, fmap, var_value)
    return p


def conditional(variables, factors, fmap, weight_value, vid, var_value):
    """Gibbs conditional distribution over values of `vid`."""
    card = int(variables[vid]["cardinality"])
    logits = np.array([potential(variables, factors, fmap, weight_value,
                                 vid, k, var_value) for k in range(card)])
    z = np.exp(logits - logits.max())
    return z / z.sum()


def exact_marginals(variables, factors, fmap, weight_value,
                    sample_evidence=True):
    """Exact stationary marginals of the slot-based Gibbs chain.

    Brute-force: builds the chain's transition structure implicitly by
    enumerating the joint exp(sum_f w_f * eval_f(x)); valid when the
    slot-based conditionals are consistent with that joint (always true for
    dataType==0 variables, which use a single complete adjacency slot).

    Evidence variables are part of the state when sample_evidence, else
    clamped at initialValue. Returns (V, K_max) marginal array.
    """
    n = len(variables)
    kmax = int(max(variables["cardinality"]))
    free = [v for v in range(n)
            if variables[v]["isEvidence"] == 0
            or (sample_evidence and variables[v]["isEvidence"] == 1)]
    assert all(variables[v]["dataType"] == 0 for v in free), \
        "exact enumeration assumes complete (dataType==0) adjacency slots"
    cards = [int(variables[v]["cardinality"]) for v in free]
    state = variables["initialValue"].astype(np.int64).copy()
    marg = np.zeros((n, kmax))
    total = 0.0

    def log_joint():
        s = 0.0
        for fid in range(len(factors)):
            wid = int(factors[fid]["weightId"])
            # var_samp=-1: no substitution, evaluate at current state
            s += float(weight_value[wid]) * eval_factor(
                fid, -1, 0, variables, factors, fmap, state)
        return s

    idx = [0] * len(free)
    while True:
        for v, k in zip(free, idx):
            state[v] = k
        w = math.exp(log_joint())
        total += w
        for v, k in zip(free, idx):
            marg[v, k] += w
        # odometer
        i = 0
        while i < len(free):
            idx[i] += 1
            if idx[i] < cards[i]:
                break
            idx[i] = 0
            i += 1
        else:
            break
        if i == len(free):
            break
    marg /= total
    # clamped variables have a point-mass marginal
    for v in range(n):
        if v not in free:
            marg[v, int(state[v])] = 1.0
    return marg
