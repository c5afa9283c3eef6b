"""Sampler state and the plain per-color potential computation.

Partial port of ``numbskull_tpu/ops/gibbs.py``: ``SamplerState``, the
initial state, and ``color_potentials`` — the potentials of every
variable of one color at every candidate value, computed with gathers,
one broadcast factor evaluation and ``index_add_``. It is the plain
version that ``ops/itemgrid.color_step_reference`` draws from, and the
tests hold the CUDA sweep kernel to it. The XLA-style ``GibbsEngine``
and learning are not ported yet (ROADMAP, port queue).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import ColorPlan, CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import eval_factors


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


def plan_tensors(plan: ColorPlan, device) -> dict:
    """The fields of one ColorPlan that inference reads, as tensors on
    ``device`` (index fields as int64, masks as bool)."""
    out = {}
    for name in _PLAN_FIELDS:
        a = np.asarray(getattr(plan, name))
        if a.dtype == np.bool_:
            out[name] = torch.as_tensor(a, device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.int64), device=device)
    return out


def color_potentials(pd: dict, kmax: int, present, var_value: torch.Tensor,
                     weight_value: torch.Tensor) -> torch.Tensor:
    """Potentials (R, kmax) for one color's rows, all values at once.

    Equivalent to the reference's potential() (numbskull/inference.py:
    55-71) looped over every variable of the color and every candidate
    value; featureValue is absent, as in the reference's inference.
    Item contributions are summed in item order per row (``index_add_``
    on the CPU; on the GPU the order is free, which is exact for dyadic
    weights).
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
    return pot.index_add_(0, pd["it_row"], contrib)
