"""The DeepDive factor-graph records the generators fill.

The dtypes are the interop layer of upstream numbskull
(numbskull/numbskulltypes.py:11-39); numpy compares structured dtypes by
their fields, so arrays of these dtypes are what ``NumbSkull.
loadFactorGraph`` takes.
"""

from __future__ import annotations

import numpy as np

WEIGHT = np.dtype([("isFixed", np.bool_), ("initialValue", np.float64)])
VARIABLE = np.dtype([("isEvidence", np.int8), ("initialValue", np.int64),
                     ("dataType", np.int16), ("cardinality", np.int64),
                     ("vtf_offset", np.int64)])
FACTOR = np.dtype([("factorFunction", np.int16), ("weightId", np.int64),
                   ("featureValue", np.float64), ("arity", np.int64),
                   ("ftv_offset", np.int64)])
FMAP = np.dtype([("vid", np.int64), ("dense_equal_to", np.int64)])

#: factor function codes (upstream numbskull/inference.py:74-143)
FUNC = {"DP_GEN_CLASS_PRIOR": 18, "DP_GEN_LF_PRIOR": 19,
        "DP_GEN_LF_PROPENSITY": 20, "DP_GEN_LF_ACCURACY": 21,
        "DP_GEN_LF_CLASS_PROPENSITY": 22, "DP_GEN_DEP_FIXING": 23,
        "DP_GEN_DEP_REINFORCING": 24, "DP_GEN_DEP_EXCLUSIVE": 25,
        "DP_GEN_DEP_SIMILAR": 26}
