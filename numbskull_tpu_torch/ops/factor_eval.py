"""Vectorised evaluation of all 25 factor functions on torch tensors.

Port of ``numbskull_tpu/ops/factor_eval.py``: every work item evaluates
as masked reductions over a padded argument axis, and the per-type
results combine through the one semantics table
(``ops/factor_semantics.finalize``) over the factor types present.

The caller substitutes the hypothetical value of the active variable
into ``vals`` before the call, as the JAX package does.

Intentional deviation from the reference, kept from the JAX package
(see golden.py and PARITY.md): IMPLY_MLN, IMPLY_NATURAL_CAT and
IMPLY_MLN_CAT read the head through the head variable's value.
"""

from __future__ import annotations

import numpy as np
import torch

from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.ops.factor_semantics import ArgStats, finalize


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[...]]`` with ``idx`` (..., ) broadcast against the
    batch dimensions of ``x`` (torch.gather does not broadcast)."""
    batch = torch.broadcast_shapes(x.shape[:-1], idx.shape)
    x = x.expand(*batch, x.shape[-1])
    idx = idx.expand(batch).unsqueeze(-1)
    return torch.gather(x, -1, idx).squeeze(-1)


def eval_factors(ftype, vals, eq, valid, card, arity, present_types):
    """Evaluate factors for a batch of work items.

    Args:
      ftype: (...,) int32 factor-function codes.
      vals:  (..., A) int32 argument values, hypothetical already
             substituted at the active variable's positions.
      eq:    (..., A) int32 dense equal-to per argument.
      valid: (..., A) bool argument-padding mask.
      card:  (..., A) int32 cardinality of each argument's variable.
      arity: (...,) int32 true arity (head = argument arity-1).
      present_types: iterable of the factor codes in the batch.

    Returns:
      (...,) float32 factor values; padding items (NOOP) give 0.

    UFO reads the argument at position v0-1 clipped into the factor's
    own arity; the JAX engines read a padding slot there, whose content
    depends on the padded width.
    """
    A = vals.shape[-1]
    pos = torch.arange(A, dtype=torch.int32, device=vals.device)
    head_idx = torch.clamp(arity - 1, min=0).to(torch.int64)
    is_head = pos == head_idx.unsqueeze(-1)
    body = valid & ~is_head

    head = _take_last(vals, head_idx)
    head_eq = _take_last(eq, head_idx)
    v0 = vals[..., 0]
    uidx = torch.minimum(torch.clamp(v0 - 1, min=0).to(torch.int64),
                         head_idx)
    ufo_sel = _take_last(vals, uidx)
    zero = torch.zeros_like(v0)
    st = ArgStats(
        n_zero=(valid & (vals == 0)).sum(-1),
        n_one=(valid & (vals == 1)).sum(-1),
        n_diff0=(valid & (vals != v0.unsqueeze(-1))).sum(-1),
        n_head_eq=(body & (vals == head.unsqueeze(-1))).sum(-1),
        n_body_zero=(body & (vals == 0)).sum(-1),
        n_neq_eq=(valid & (vals != eq)).sum(-1),
        n_eq_eq=(valid & (vals == eq)).sum(-1),
        n_body_neq_eq=(body & (vals != eq)).sum(-1),
        head=head, head_eq=head_eq,
        v0=v0,
        v1=vals[..., 1] if A > 1 else zero,
        v2=vals[..., 2] if A > 2 else zero,
        card0=card[..., 0],
        card1=card[..., 1] if A > 1 else card[..., 0],
        ufo_sel=ufo_sel)
    return finalize(present_types, ftype, st)


def present_types_of(ftype_array) -> tuple[int, ...]:
    """The factor codes in a host ftype array, NOOP excluded."""
    u = np.unique(np.asarray(ftype_array))
    return tuple(int(t) for t in u if t != T.FUNC_NOOP)
