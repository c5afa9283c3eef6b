"""Chromatic Gibbs sweep and SGD learning sweep in tensor ops, and the
per-color potentials that the fused kernels are held to.

Port of ``numbskull_tpu/ops/gibbs.py``: ``SamplerState``, the initial
state, ``LearnParams``, ``color_potentials`` (the potentials of every
variable of one color at every candidate value, computed with gathers,
one broadcast factor evaluation and a per-row sum in item order; the
plain version that the draws of ``ops/itemgrid`` start from), and the
``GibbsEngine``: one sweep resamples the graph color by color, each
color as one vectorized step (gathers, ``index_add_``, indexed stores;
no kernel of its own), and learning advances a clamped and a free chain
and moves each weight by the difference of their factor evaluations
(reference numbskull/learning.py:46-125). A Python loop over colors
replaces the JAX package's ``lax.scan``; ``stack_plans`` and
``stack_plans_padded``, which bound XLA:TPU compile time, are not
ported. Draws use ``ops/sample.draw`` with a ``torch.Generator``, so
runs agree with the JAX engine in distribution, not bit for bit. The
partitioned engine ``parallel/bsp.BSPEngine`` runs one per part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import ColorPlan, CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import (eval_factors,
                                                 present_types_of)
from numbskull_tpu_torch.ops.sample import draw
from numbskull_tpu_torch.types import EV_EVIDENCE, EV_QUERY


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
                     weight_value: torch.Tensor,
                     ext_pot: torch.Tensor | None = None) -> torch.Tensor:
    """Potentials (R, kmax) for one color's rows, all values at once.

    Equivalent to the reference's potential() (numbskull/inference.py:
    55-71) looped over every variable of the color and every candidate
    value; featureValue is absent, as in the reference's inference.
    Item contributions are summed per row in item order on every device
    (one pass per item rank, ``pd["slots"]``), the order of the CUDA
    kernels, so the sums agree bit for bit for any weights.

    ``ext_pot``: optional (V, K') external potentials added per row
    after its items (the receiver side of boundary messages in
    partitioned execution; the reference's UFO values,
    salt/src/messages.py:1069-1079); columns beyond kmax are ignored.
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
    if ext_pot is not None:
        k = min(kmax, ext_pot.shape[1])
        pot[:, :k] += ext_pot[pd["cv_vid"], :k]
    return pot


def eval_items_at(pd: dict, present, chain: torch.Tensor,
                  value_it: torch.Tensor) -> torch.Tensor:
    """Each item's factor with its row's variable at ``value_it`` and
    its other arguments read from ``chain``."""
    vals = chain[pd["it_args_vid"]].to(torch.int64)
    sub = torch.where(pd["it_subst"], value_it.to(torch.int64)[:, None],
                      vals)
    return eval_factors(pd["it_ftype"], sub, pd["it_args_eq"],
                        pd["it_args_valid"], pd["it_args_card"],
                        pd["it_arity"], present)


# ---- the tensor-op engine (numbskull_tpu/ops/gibbs.py:418-777) ----------

def _store(chain: torch.Tensor, pd: dict, rows: torch.Tensor) -> None:
    """Write the color's new values ``rows`` (R,) into ``chain`` at its
    valid rows' variables (pad rows are dropped)."""
    chain[pd["vid_valid"]] = rows[pd["row_valid"]].to(chain.dtype)


def _color_step_infer(pd: dict, kmax: int, present, sample_evidence: bool,
                      var_value: torch.Tensor, weight_value: torch.Tensor,
                      generator: torch.Generator, ext_pot=None) -> None:
    """Resample one color block of the free chain, in place."""
    pot = color_potentials(pd, kmax, present, var_value, weight_value,
                           ext_pot)
    new = draw(pot, pd["cv_card"], generator)
    isev = pd["cv_isev"]
    upd = pd["cv_valid"] & ((isev == EV_QUERY) |
                            (bool(sample_evidence) & (isev == EV_EVIDENCE)))
    out = torch.where(upd, new, var_value[pd["cv_vid"]].to(new.dtype))
    _store(var_value, pd, out)


def _color_step_learn(pd: dict, kmax: int, present, lp: LearnParams,
                      n_weights: int, weight_fixed: torch.Tensor,
                      var_init: torch.Tensor, var_value: torch.Tensor,
                      var_value_evid: torch.Tensor,
                      weight_value: torch.Tensor, step: float,
                      generator: torch.Generator, ext_pot=None,
                      ext_pot_evid=None) -> torch.Tensor:
    """One color block of the dual-chain SGD sweep: both chains update
    in place; returns the new weights."""
    isev = pd["cv_isev"]
    valid = pd["cv_valid"]
    card = pd["cv_card"]

    # clamped chain: evidence vars pinned at initialValue, others sampled
    pot_e = color_potentials(pd, kmax, present, var_value_evid,
                             weight_value,
                             ext_pot if ext_pot_evid is None
                             else ext_pot_evid)
    e_samp = draw(pot_e, card, generator)
    init_here = var_init[pd["cv_vid"]].to(e_samp.dtype)
    e_val = torch.where(isev == EV_EVIDENCE, init_here, e_samp)

    # free chain: always sampled
    pot_p = color_potentials(pd, kmax, present, var_value, weight_value,
                             ext_pot)
    p_val = draw(pot_p, card, generator)

    upd = valid & (isev != 4)
    e_val = torch.where(upd, e_val,
                        var_value_evid[pd["cv_vid"]].to(e_val.dtype))
    p_val = torch.where(upd, p_val, var_value[pd["cv_vid"]].to(p_val.dtype))

    # gradient = (eval at proposal on free chain) - (eval at evidence on
    # clamped chain), per adjacent factor (reference learning.py:100-109)
    row = pd["it_row"]
    e_it, p_it = e_val[row], p_val[row]
    ev_e = eval_items_at(pd, present, var_value_evid, e_it)
    ev_p = eval_items_at(pd, present, var_value, p_it)
    slot_hit = (pd["it_d1"] == e_it) | (pd["it_d1"] == p_it) | \
        (pd["it_d2"] == e_it) | (pd["it_d2"] == p_it)
    include = pd["it_valid"] & (pd["it_dense"] | slot_hit)
    vmask = upd if lp.learn_non_evidence else valid & (isev == EV_EVIDENCE)
    include = include & vmask[row] & ~weight_fixed[pd["it_wid"]]

    grad = torch.where(include, (ev_p - ev_e) * pd["it_fv"], 0.0)
    dev = weight_value.device
    gw = torch.zeros(n_weights, dtype=torch.float32, device=dev).index_add_(
        0, pd["it_wid"], grad)
    nw = torch.zeros(n_weights, dtype=torch.float32, device=dev).index_add_(
        0, pd["it_wid"], include.to(torch.float32))

    # mean gradient per color step by default; 'sum' reproduces the
    # reference's aggregate movement (learning.py:111-125)
    touched = nw > 0
    if lp.grad_agg == "mean":
        gw = gw / torch.clamp(nw, min=1.0)
    w = weight_value
    if lp.regularization == 2:
        shrink = 1.0 / (1.0 + lp.reg_param * step)
        w = torch.where(touched, w * shrink - step * gw, w)
    elif lp.regularization == 1:
        w = torch.where(touched, w - step * gw, w)
        # truncated gradient (Langford et al. 2009), reference
        # learning.py:115-122: coin with prob 1/truncation, magnitude
        # reg_param * step * truncation, once per color step
        u = torch.rand(w.shape, generator=generator, device=dev)
        l1delta = lp.reg_param * step * lp.truncation
        w_trunc = torch.where(w > 0, torch.clamp(w - l1delta, min=0.0),
                              torch.clamp(w + l1delta, max=0.0))
        w = torch.where(touched & (u < 1.0 / lp.truncation), w_trunc, w)
    else:
        w = torch.where(touched, w - step * gw, w)

    _store(var_value, pd, p_val)
    _store(var_value_evid, pd, e_val)
    return w


class GibbsEngine:
    """Chromatic Gibbs sampler over a CompiledGraph in tensor ops, on
    one device (``cuda`` unless the caller asks for ``cpu``).

    ``inference`` and ``learn`` take a ``SamplerState`` and a
    ``torch.Generator`` on the engine's device (``ops/sample.
    make_generator``) and return a new state; the one given is not
    changed. ``ext_pot`` / ``ext_pot_evid`` (V, K') add external
    potentials, the boundary messages of ``parallel/bsp.BSPEngine``."""

    def __init__(self, cg: CompiledGraph, device="cuda"):
        self.cg = cg
        self.device = torch.device(device)
        self.kmax = cg.kmax
        self.n_vars = cg.n_vars
        self.n_weights = cg.n_weights
        self.plans = [self._plan(p) for p in cg.plans]
        self.present = [present_types_of(p.it_ftype) for p in cg.plans]
        dev = self.device
        self.var_isev = torch.as_tensor(np.asarray(cg.var_isev, np.int64),
                                        device=dev)
        self.var_init = torch.as_tensor(np.asarray(cg.var_init, np.int32),
                                        device=dev)
        self.weight_fixed = torch.as_tensor(
            np.asarray(cg.weight_fixed, bool), device=dev)

    def _plan(self, plan: ColorPlan) -> dict:
        pd = plan_tensors(plan, self.device)
        pd["row_valid"] = torch.nonzero(pd["cv_valid"]).flatten()
        pd["vid_valid"] = pd["cv_vid"][pd["row_valid"]]
        return pd

    # ---- state -----------------------------------------------------------

    def init_state(self) -> SamplerState:
        return init_state(self.cg, self.device)

    # ---- sweeps ----------------------------------------------------------

    def _sweep_infer(self, sample_evidence, var_value, weight_value,
                     generator, ext_pot=None) -> None:
        for pd, present in zip(self.plans, self.present):
            _color_step_infer(pd, self.kmax, present, sample_evidence,
                              var_value, weight_value, generator, ext_pot)

    def _tally_mask(self, sample_evidence: bool) -> torch.Tensor:
        isev = self.var_isev
        return (isev == EV_QUERY) | (bool(sample_evidence) &
                                     (isev == EV_EVIDENCE))

    def _ext(self, ext):
        if ext is None:
            return None
        return torch.as_tensor(ext, dtype=torch.float32, device=self.device)

    def inference(self, state: SamplerState, generator: torch.Generator,
                  epochs: int, burn: int = 0, sample_evidence: bool = True,
                  ext_pot=None) -> SamplerState:
        """Burn in, then run ``epochs`` tallying sweeps of the free
        chain."""
        ext = self._ext(ext_pot)
        vv = state.var_value.clone()
        w = state.weight_value
        for _ in range(burn):
            self._sweep_infer(sample_evidence, vv, w, generator, ext)
        cnt = state.count.clone()
        mask = self._tally_mask(sample_evidence)
        ks = torch.arange(self.kmax, device=self.device)
        for _ in range(epochs):
            self._sweep_infer(sample_evidence, vv, w, generator, ext)
            cnt += ((vv[:, None] == ks[None, :]) &
                    mask[:, None]).to(cnt.dtype)
        return dataclasses.replace(state, var_value=vv, count=cnt)

    def learn(self, state: SamplerState, generator: torch.Generator,
              epochs: int, stepsize: float, decay: float = 1.0,
              burn: int = 0, lp: LearnParams = LearnParams(), ext_pot=None,
              ext_pot_evid=None) -> SamplerState:
        """Dual-chain SGD weight learning (burn-in samples evidence).
        Without ``ext_pot_evid`` the clamped chain takes ``ext_pot``."""
        ext, ext_e = self._ext(ext_pot), self._ext(ext_pot_evid)
        vv = state.var_value.clone()
        ve = state.var_value_evid.clone()
        w = state.weight_value
        for _ in range(burn):
            self._sweep_infer(True, vv, w, generator, ext)
        for i in range(epochs):
            step = float(np.float32(stepsize) *
                         np.power(np.float32(decay), np.float32(i)))
            for pd, present in zip(self.plans, self.present):
                w = _color_step_learn(pd, self.kmax, present, lp,
                                      self.n_weights, self.weight_fixed,
                                      self.var_init, vv, ve, w, step,
                                      generator, ext, ext_e)
        return dataclasses.replace(state, var_value=vv, var_value_evid=ve,
                                   weight_value=w)

    def marginals(self, state: SamplerState, epochs: int) -> np.ndarray:
        """(V, K) marginal estimates = count / epochs."""
        return state.count.cpu().numpy() / float(max(epochs, 1))
