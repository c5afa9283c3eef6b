"""Sampler state and the plain per-color potential computation.

Partial port of ``numbskull_tpu/ops/gibbs.py``: ``SamplerState``, the
initial state, ``LearnParams``, and ``color_potentials`` — the
potentials of every variable of one color at every candidate value,
computed with gathers, one broadcast factor evaluation and a per-row sum
in item order. It is the plain version that the draws of
``ops/itemgrid`` (``color_step_reference``,
``learn_color_step_reference``) start from, and the tests hold the CUDA
kernels to it. The XLA-style ``GibbsEngine`` is not ported yet (ROADMAP,
port queue M1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import ColorPlan, CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import eval_factors


@dataclasses.dataclass(frozen=True)
class LearnParams:
    """Static learning hyperparameters (numbskull_tpu/ops/gibbs.py:51-63,
    the same fields and defaults)."""

    regularization: int = 2     # 0 none, 1 L1 truncated gradient, 2 L2
    reg_param: float = 0.01
    truncation: int = 1
    learn_non_evidence: bool = False
    # 'mean': mean gradient per color step (default); 'sum': the
    # reference's aggregate movement (learning.py:111-125)
    grad_agg: str = "mean"


@dataclasses.dataclass
class SamplerState:
    """Sampler state; every tensor lives on one device."""

    var_value: torch.Tensor        # (V,) int32 free-chain values
    var_value_evid: torch.Tensor   # (V,) int32 clamped-chain values
    weight_value: torch.Tensor     # (W,) float32
    count: torch.Tensor            # (V, K) int32 marginal tallies

    @property
    def device(self) -> torch.device:
        return self.var_value.device


def init_state(cg: CompiledGraph, device) -> SamplerState:
    """Initial values, initial weights and zero tallies on ``device``."""
    v0 = torch.as_tensor(np.asarray(cg.var_init, np.int32), device=device)
    return SamplerState(
        var_value=v0,
        var_value_evid=v0.clone(),
        weight_value=torch.as_tensor(
            np.asarray(cg.weight_init, np.float32), device=device),
        count=torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                          device=device),
    )


_PLAN_FIELDS = ("cv_vid", "cv_card", "cv_isev", "cv_valid", "it_row",
                "it_ftype", "it_wid", "it_dense", "it_d1", "it_d2",
                "it_valid", "it_arity", "it_args_vid", "it_args_eq",
                "it_args_valid", "it_args_card", "it_subst")


def plan_tensors(plan: ColorPlan, device, items=None, rows=None) -> dict:
    """The fields of one ColorPlan that the plain versions read, as
    tensors on ``device`` (index fields as int64, masks as bool,
    ``it_fv`` as float32). ``items`` keeps only those items, in that
    order; each row's potential then sums its items in that order.
    ``rows`` keeps only those rows (a shard's), renumbered in that
    order; every kept item must sit on a kept row.

    ``slots`` holds, per rank d, the valid items that are the d-th of
    their row, so that ``color_potentials`` adds them in item order."""
    arrays = {}
    for name in _PLAN_FIELDS + ("it_fv",):
        a = np.asarray(getattr(plan, name))
        arrays[name] = a[items] if items is not None and \
            name.startswith("it_") else a
    if rows is not None:
        rows = np.asarray(rows, np.int64)
        local = np.full(len(plan.cv_vid), -1, np.int64)
        local[rows] = np.arange(len(rows))
        for name in _PLAN_FIELDS:
            if name.startswith("cv_"):
                arrays[name] = arrays[name][rows]
        arrays["it_row"] = local[arrays["it_row"]]
    out = {}
    for name, a in arrays.items():
        if a.dtype == np.bool_:
            out[name] = torch.as_tensor(a, device=device)
        elif name == "it_fv":
            out[name] = torch.as_tensor(a.astype(np.float32), device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.int64), device=device)
    out["slots"] = [torch.as_tensor(s, device=device) for s in
                    _rank_slots(arrays["it_row"], arrays["it_valid"])]
    return out


def _rank_slots(it_row: np.ndarray, it_valid: np.ndarray) -> list:
    """Valid item indices grouped by their rank within their row (item
    order): entry d lists the d-th item of every row that has one."""
    idx = np.flatnonzero(it_valid)
    if not len(idx):
        return []
    rows = it_row[idx].astype(np.int64)
    order = np.argsort(rows, kind="stable")
    rs = rows[order]
    rank = np.arange(len(rs)) - np.searchsorted(rs, rs, side="left")
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.cumsum(np.bincount(rank))[:-1]
    return np.split(idx[order][by_rank], bounds)


def color_potentials(pd: dict, kmax: int, present, var_value: torch.Tensor,
                     weight_value: torch.Tensor) -> torch.Tensor:
    """Potentials (R, kmax) for one color's rows, all values at once.

    Equivalent to the reference's potential() (numbskull/inference.py:
    55-71) looped over every variable of the color and every candidate
    value; featureValue is absent, as in the reference's inference.
    Item contributions are summed per row in item order on every device
    (one pass per item rank, ``pd["slots"]``), the order of the CUDA
    kernels, so the sums agree bit for bit for any weights.
    """
    vals = var_value[pd["it_args_vid"]].to(torch.int64)            # (I, A)
    ks = torch.arange(kmax, dtype=torch.int64, device=vals.device)
    sub = torch.where(pd["it_subst"][:, None, :], ks[None, :, None],
                      vals[:, None, :])                            # (I, K, A)
    e = eval_factors(pd["it_ftype"][:, None], sub,
                     pd["it_args_eq"][:, None, :],
                     pd["it_args_valid"][:, None, :],
                     pd["it_args_card"][:, None, :],
                     pd["it_arity"][:, None], present)             # (I, K)
    w = weight_value[pd["it_wid"]]                                 # (I,)
    row_card = pd["cv_card"][pd["it_row"]]                         # (I,)
    ok = torch.where(pd["it_dense"][:, None],
                     ks[None, :] < row_card[:, None],
                     (ks[None, :] == pd["it_d1"][:, None]) |
                     (ks[None, :] == pd["it_d2"][:, None]))
    contrib = torch.where(ok & pd["it_valid"][:, None], w[:, None] * e,
                          torch.zeros((), dtype=torch.float32,
                                      device=e.device))
    R = pd["cv_card"].shape[0]
    pot = torch.zeros((R, kmax), dtype=torch.float32, device=e.device)
    for sl in pd["slots"]:
        rows = pd["it_row"][sl]
        pot[rows] = pot[rows] + contrib[sl]
    return pot
