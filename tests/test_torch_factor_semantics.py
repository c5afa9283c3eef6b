"""The port's factor evaluation against the golden oracle and the JAX
package, on all 25 factor codes with random arguments (as
tests/test_factor_eval.py builds them). Tolerance 0: the oracle's value
rounded to float32 and the JAX value must come out exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from numbskull_tpu import golden
from numbskull_tpu.ops.factor_eval import eval_factors as jax_eval_factors
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.ops.factor_eval import eval_factors, present_types_of

from _torch_threads import cap_threads

cap_threads()

BOOL_FUNCS = [T.FUNC_IMPLY_NATURAL, T.FUNC_OR, T.FUNC_AND, T.FUNC_EQUAL,
              T.FUNC_ISTRUE, T.FUNC_LINEAR, T.FUNC_RATIO, T.FUNC_LOGICAL,
              T.FUNC_IMPLY_MLN]
CAT_FUNCS = [T.FUNC_AND_CAT, T.FUNC_OR_CAT, T.FUNC_EQUAL_CAT_CONST,
             T.FUNC_IMPLY_NATURAL_CAT, T.FUNC_IMPLY_MLN_CAT]
DP_FUNCS = [T.FUNC_DP_GEN_CLASS_PRIOR, T.FUNC_DP_GEN_LF_PRIOR,
            T.FUNC_DP_GEN_LF_PROPENSITY, T.FUNC_DP_GEN_LF_ACCURACY,
            T.FUNC_DP_GEN_LF_CLASS_PROPENSITY, T.FUNC_DP_GEN_DEP_FIXING,
            T.FUNC_DP_GEN_DEP_REINFORCING, T.FUNC_DP_GEN_DEP_EXCLUSIVE,
            T.FUNC_DP_GEN_DEP_SIMILAR]
ALL_FUNCS = BOOL_FUNCS + CAT_FUNCS + DP_FUNCS + [T.FUNC_UFO, T.FUNC_NOOP]


def _arity(rng, ftype):
    if ftype in (T.FUNC_DP_GEN_DEP_FIXING, T.FUNC_DP_GEN_DEP_REINFORCING):
        return 3
    if ftype in (T.FUNC_DP_GEN_CLASS_PRIOR, T.FUNC_DP_GEN_LF_PRIOR,
                 T.FUNC_DP_GEN_LF_PROPENSITY):
        return 1
    if ftype in DP_FUNCS:
        return 2
    if ftype == T.FUNC_UFO:
        return int(rng.integers(2, 5))
    return int(rng.integers(1 if ftype != T.FUNC_EQUAL else 2, 6))


def _cases(ftype, trials=40):
    """Random single-factor cases: (padded args, golden value)."""
    rng = np.random.default_rng(42 + (ftype % 97))
    card = 3 if ftype in DP_FUNCS or ftype in CAT_FUNCS else 2
    A = 6                                     # padded argument width
    rows = {k: [] for k in ("vals", "eq", "valid", "card", "arity")}
    want = []
    for _ in range(trials):
        arity = _arity(rng, ftype)
        n_vars = arity + 2
        variables = T.new_variables(n_vars)
        variables["dataType"] = 1 if ftype in CAT_FUNCS else 0
        variables["cardinality"] = card
        factors = T.new_factors(1)
        factors["factorFunction"][0] = ftype
        factors["arity"][0] = arity
        factors["featureValue"][0] = 1.0
        fmap = T.new_fmap(arity)
        fmap["vid"] = rng.integers(0, n_vars, arity)
        fmap["dense_equal_to"] = rng.integers(0, card, arity)
        var_value = rng.integers(0, card, n_vars)
        var_samp = int(fmap["vid"][rng.integers(0, arity)])
        value = int(rng.integers(0, card))
        want.append(golden.eval_factor(0, var_samp, value, variables,
                                       factors, fmap, var_value))
        vids = np.zeros(A, np.int64)
        vids[:arity] = fmap["vid"]
        valid = np.arange(A) < arity
        vals = np.where(valid, np.where(vids == var_samp, value,
                                        var_value[vids]), 0)
        eq = np.zeros(A, np.int64)
        eq[:arity] = fmap["dense_equal_to"]
        rows["vals"].append(vals)
        rows["eq"].append(eq)
        rows["valid"].append(valid)
        rows["card"].append(np.where(valid, card, 1))
        rows["arity"].append(arity)
    arrs = {k: np.asarray(v) for k, v in rows.items()}
    arrs["vals"] = arrs["vals"].astype(np.int32)
    arrs["eq"] = arrs["eq"].astype(np.int32)
    arrs["card"] = arrs["card"].astype(np.int32)
    arrs["arity"] = arrs["arity"].astype(np.int32)
    return arrs, np.asarray(want, np.float32)


@pytest.mark.parametrize("ftype", ALL_FUNCS)
def test_eval_factors_exact(ftype):
    a, want = _cases(ftype)
    n = len(want)
    ft = np.full(n, ftype, np.int32)
    present = present_types_of(ft) + (T.FUNC_NOOP,)
    got = eval_factors(torch.as_tensor(ft), torch.as_tensor(a["vals"]),
                       torch.as_tensor(a["eq"]), torch.as_tensor(a["valid"]),
                       torch.as_tensor(a["card"]),
                       torch.as_tensor(a["arity"]), present)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(jax_eval_factors(
        jnp.asarray(ft), jnp.asarray(a["vals"]), jnp.asarray(a["eq"]),
        jnp.asarray(a["valid"]), jnp.asarray(a["card"]),
        jnp.asarray(a["arity"]), present))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mixed_batch_and_absent_types():
    """All codes in one batch, each row evaluated under the full present
    set, equals the per-code results; codes absent from ``present``
    give 0."""
    cases = [_cases(t, trials=8) for t in ALL_FUNCS]
    ft = np.concatenate([np.full(len(w), t, np.int32)
                         for t, (_, w) in zip(ALL_FUNCS, cases)])
    cat = {k: np.concatenate([c[0][k] for c in cases])
           for k in ("vals", "eq", "valid", "card", "arity")}
    want = np.concatenate([w for _, w in cases])
    args = [torch.as_tensor(ft)] + [torch.as_tensor(cat[k]) for k in
                                    ("vals", "eq", "valid", "card",
                                     "arity")]
    got = eval_factors(*args, tuple(T.FACTORS.values()))
    np.testing.assert_array_equal(got.numpy(), want)
    none = eval_factors(*args, ())
    assert not none.any()
