"""The 25 factor-function semantics on torch tensors.

Port of ``numbskull_tpu/ops/factor_semantics.py``. Every engine
evaluates a factor in two steps: it computes a small set of argument
statistics (:class:`ArgStats`), then :func:`finalize` maps (factor code,
statistics) to the factor value. This module is the plain PyTorch
version of that table; the CUDA sweep kernel
(``csrc/itemgrid_sweep.cu``, ``finalize``) carries the same table as a
``__device__`` function, and the tests hold the two to each other.

Parity target: ``golden.eval_factor`` of the JAX package, including its
intentional deviation: IMPLY_MLN, IMPLY_NATURAL_CAT and IMPLY_MLN_CAT
read the head through the head variable's value (see PARITY.md).
"""

from __future__ import annotations

import dataclasses

import torch

from numbskull_tpu_torch import types as T


@dataclasses.dataclass
class ArgStats:
    """Argument statistics of a batch of factor evaluations.

    All fields are integer tensors that broadcast against each other.
    ``body`` means positions < arity-1.
    """

    n_zero: torch.Tensor        # sum over valid args of [v == 0]
    n_one: torch.Tensor         # sum over valid args of [v == 1]
    n_diff0: torch.Tensor       # sum over valid args of [v != v0]
    n_head_eq: torch.Tensor     # sum over BODY args of [v == head]
    n_body_zero: torch.Tensor   # sum over BODY args of [v == 0]
    n_neq_eq: torch.Tensor      # sum over valid args of [v != eq]
    n_eq_eq: torch.Tensor       # sum over valid args of [v == eq]
    n_body_neq_eq: torch.Tensor  # sum over BODY args of [v != eq]
    head: torch.Tensor          # value of the arg at position arity-1
    head_eq: torch.Tensor       # dense_equal_to at position arity-1
    v0: torch.Tensor            # value of arg 0
    v1: torch.Tensor            # value of arg 1 (0 when absent)
    v2: torch.Tensor            # value of arg 2 (0 when absent)
    card0: torch.Tensor         # cardinality of arg 0's variable
    card1: torch.Tensor         # cardinality of arg 1's variable
    ufo_sel: torch.Tensor       # value of the arg at position v0-1


def _sel(cond, a, b):
    return torch.where(cond, a, b)


def finalize(present, ftype: torch.Tensor, st: ArgStats) -> torch.Tensor:
    """Map factor codes and ArgStats to float32 factor values.

    ``present``: iterable of the factor codes that may occur; absent
    codes cost nothing. ``ftype``: int tensor of codes; NOOP and
    padding give 0.
    """
    head = st.head
    shape = torch.broadcast_shapes(ftype.shape, st.n_zero.shape)
    out = torch.zeros(shape, dtype=torch.float32, device=ftype.device)
    for t in present:
        if t == T.FUNC_NOOP:
            continue
        if t == T.FUNC_IMPLY_NATURAL:
            val = _sel(st.n_zero > 0, 0.0, _sel(head != 0, 1.0, -1.0))
        elif t == T.FUNC_OR:
            val = _sel(st.n_one > 0, 1.0, -1.0)
        elif t == T.FUNC_EQUAL:
            val = _sel(st.n_diff0 > 0, -1.0, 1.0)
        elif t in (T.FUNC_AND, T.FUNC_ISTRUE):
            val = _sel(st.n_zero > 0, -1.0, 1.0)
        elif t == T.FUNC_LINEAR:
            val = st.n_head_eq.to(torch.float32)
        elif t == T.FUNC_RATIO:
            val = torch.log1p(st.n_head_eq.to(torch.float32))
        elif t == T.FUNC_LOGICAL:
            val = _sel(st.n_head_eq > 0, 1.0, 0.0)
        elif t == T.FUNC_IMPLY_MLN:
            val = _sel(st.n_body_zero > 0, 1.0, _sel(head != 0, 1.0, 0.0))
        elif t in (T.FUNC_AND_CAT, T.FUNC_EQUAL_CAT_CONST):
            val = _sel(st.n_neq_eq > 0, 0.0, 1.0)
        elif t == T.FUNC_OR_CAT:
            val = _sel(st.n_eq_eq > 0, 1.0, -1.0)
        elif t == T.FUNC_IMPLY_NATURAL_CAT:
            val = _sel(st.n_body_neq_eq > 0, 0.0,
                       _sel(head == st.head_eq, 1.0, -1.0))
        elif t == T.FUNC_IMPLY_MLN_CAT:
            val = _sel(st.n_body_neq_eq > 0, 1.0,
                       _sel(head == st.head_eq, 1.0, 0.0))
        elif t == T.FUNC_DP_GEN_CLASS_PRIOR:
            val = _sel(st.v0 == 1, 1.0, -1.0)
        elif t == T.FUNC_DP_GEN_LF_PRIOR:
            val = _sel(st.v0 == 2, -1.0, _sel(st.v0 == 0, 0.0, 1.0))
        elif t == T.FUNC_DP_GEN_LF_PROPENSITY:
            val = _sel(st.v0 == st.card0 - 1, 0.0, 1.0)
        elif t == T.FUNC_DP_GEN_LF_ACCURACY:
            val = _sel(st.v1 == st.card1 - 1, 0.0,
                       _sel(st.v0 == st.v1, 1.0, -1.0))
        elif t == T.FUNC_DP_GEN_LF_CLASS_PROPENSITY:
            val = _sel(st.v1 == st.card1 - 1, 0.0,
                       _sel(st.v0 == 1, 1.0, -1.0))
        elif t in (T.FUNC_DP_GEN_DEP_FIXING, T.FUNC_DP_GEN_DEP_REINFORCING):
            y, l1, l2 = st.v0, st.v1, st.v2
            abstain = _sel(l2 != 1, -1.0, 0.0)
            if t == T.FUNC_DP_GEN_DEP_FIXING:
                hit = ((l1 == 0) & (l2 == 1) & (y == 1)) | \
                      ((l1 == 1) & (l2 == 0) & (y == 0))
            else:
                hit = ((l1 == 0) & (l2 == 0) & (y == 0)) | \
                      ((l1 == 1) & (l2 == 1) & (y == 1))
            val = _sel(l1 == st.card1 - 1, abstain, _sel(hit, 1.0, 0.0))
        elif t == T.FUNC_DP_GEN_DEP_EXCLUSIVE:
            ab = st.card0 - 1
            val = _sel((st.v0 == ab) | (st.v1 == ab), 0.0, -1.0)
        elif t == T.FUNC_DP_GEN_DEP_SIMILAR:
            val = _sel(st.v0 == st.v1, 1.0, 0.0)
        elif t == T.FUNC_UFO:
            val = _sel(st.v0 == 0, 0.0, st.ufo_sel.to(torch.float32))
        else:
            raise ValueError("unknown factor function %d" % t)
        out = torch.where(ftype == t, val, out)
    return out
