"""Bulk-synchronous partitioned Gibbs: the reference's distributed mode.

Port of ``numbskull_tpu/parallel/bsp.py``. Reference analog: the salt
master/minion epoch loop (salt/src/numbskull_master.py:133-233,
salt/src/numbskull_minion.py:225-280): each part samples its owned
variables against one-sync-stale boundary values, parts exchange after
every local epoch, and learning sums per-part weight deltas at the
coordinator (numbskull_master.py:223-224).

Two boundary treatments:

- ``mode="values"``: a straddling factor is replicated on every part that
  owns one of its variables; ghost (non-owned) variable values refresh at
  each sync (the reference's default exchange, salt/src/messages.py:
  1253-1319).
- ``mode="messages"``: every factor lives only on its owner part; a part
  whose variable appears in a remote factor receives a per-value
  potential message instead: m(v, k) = sum over remote factors f touching
  v of w_f * eval_f(v=k, sender's current values). This generalizes the
  reference's UFO (messages.py:942-1066) and PF (messages.py:1332-1355)
  boundary compressions to every factor type, and is exact for the
  receiver's conditional.

Two engines, as in the JAX package:

- :class:`BSPItemGridInference` runs each part on the fused kernels
  (``ops/itemgrid.ItemGridEngine``); messages enter the kernels' has_ext
  forms as external potentials. The global chains, the ownership masks,
  the tallies and the messages stay on the device: the exchange is one
  ``torch.where`` per part and the messages one ``index_add_`` per part,
  where the JAX class goes through host numpy arrays.
- :class:`BSPEngine` runs each part on the tensor-op
  ``ops/gibbs.GibbsEngine``; the CLI's ``--parts N`` runs it.

Every part compiles the whole graph: its non-owned variables are frozen
rows (isEvidence=4, reference numbskull/inference.py:21-23) that the
sweep visits and leaves unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import (
    ColorPlan, _pad_to, build_attachments, compile_graph, fold_attachments,
    pack_item_block,
)
from numbskull_tpu_torch.ops.factor_eval import present_types_of
from numbskull_tpu_torch.ops.gibbs import (
    GibbsEngine, LearnParams, SamplerState, color_potentials, plan_tensors,
)
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine, _i32


def factor_owner(factors, fmap, part: np.ndarray) -> np.ndarray:
    """(F,) owner part of each factor = part of its first variable
    (deterministic stand-in for the reference's partition-key schemes,
    salt/src/numbskull_master.py:329-334)."""
    first_vid = fmap["vid"][factors["ftv_offset"].astype(np.int64)]
    return part[first_vid.astype(np.int64)]


@dataclasses.dataclass
class MessagePlan:
    """Outgoing boundary messages of one or more parts (blocks):
    ``color_potentials`` over ``pd`` gives (R, K) potentials, and block
    b's rows ``row0[b]`` .. ``row0[b] + len(scatter_vid[b])`` are its
    messages to the variables ``scatter_vid[b]``."""

    pd: dict                    # color_potentials' plan tensors
    present: tuple              # factor types present
    scatter_vid: list           # per block: (n,) int64 target variable ids
    row0: list                  # per block: its first row

    @property
    def n_targets(self) -> int:
        return sum(len(t) for t in self.scatter_vid)


def _message_block(variables, factors, fmap, owned_fids: np.ndarray,
                   target_mask: np.ndarray, n_vars: int,
                   item_pad: int = 128, row_pad: int = 8) -> dict | None:
    """One part's message rows as numpy arrays: m(v, k) over all
    non-owned variables v touched by this part's owned factors (rows =
    target variables, items = (factor, v) incidences; the compiler's
    attachment/fold/pack pipeline). None when the part sends nothing."""
    F = len(factors)
    skip = np.setdiff1d(np.arange(F, dtype=np.int64), owned_fids,
                        assume_unique=False)
    att_f, att_v, att_d = build_attachments(variables, factors, fmap,
                                            factors_to_skip=skip)
    sel = target_mask[att_v]
    att_f, att_v, att_d = att_f[sel], att_v[sel], att_d[sel]
    if not len(att_f):
        return None
    item_f, item_v, item_d1, item_d2 = fold_attachments(att_f, att_v, att_d)

    tvids = np.unique(item_v)
    R = _pad_to(len(tvids), row_pad) + 1
    row_of = np.zeros(n_vars, np.int64)
    row_of[tvids] = np.arange(len(tvids))

    order = np.argsort(row_of[item_v], kind="stable")
    it, amax = pack_item_block(variables, factors, fmap,
                               item_f[order], item_v[order],
                               item_d1[order], item_d2[order],
                               row_of[item_v[order]], R, item_pad=item_pad)
    cv_vid = np.zeros(R, np.int32)
    cv_card = np.ones(R, np.int32)
    cv_vid[:len(tvids)] = tvids
    cv_card[:len(tvids)] = variables["cardinality"][tvids]
    return dict(it=it, amax=amax, cv_vid=cv_vid, cv_card=cv_card,
                tvids=tvids.astype(np.int64))


# fill of the argument columns a narrower block lacks (pack_item_block's)
_ARG_FILL = {"it_args_vid": 0, "it_args_eq": 0, "it_args_valid": False,
             "it_args_card": 1, "it_subst": False}


def _message_plan(blocks: list, device) -> MessagePlan | None:
    """The message blocks (``_message_block``, None dropped) stacked row
    after row into one plan of the tensors ``color_potentials`` reads
    (``slots`` included, as ``plan_tensors`` builds them), so that one
    call computes every block's messages; each row sums its own items in
    its block's order."""
    blocks = [b for b in blocks if b is not None]
    if not blocks:
        return None
    amax = max(b["amax"] for b in blocks)
    row0 = np.cumsum([0] + [len(b["cv_vid"]) for b in blocks[:-1]])
    it = {}
    for key in blocks[0]["it"]:
        cols = []
        for b, r0 in zip(blocks, row0):
            a = b["it"][key]
            if key == "it_row":
                a = a + r0
            elif a.ndim == 2 and a.shape[1] < amax:
                a = np.pad(a, ((0, 0), (0, amax - a.shape[1])),
                           constant_values=_ARG_FILL[key])
            cols.append(a)
        it[key] = np.concatenate(cols)
    cv_vid = np.concatenate([b["cv_vid"] for b in blocks])
    cv_card = np.concatenate([b["cv_card"] for b in blocks])
    valid = np.concatenate([np.arange(len(b["cv_vid"])) < len(b["tvids"])
                            for b in blocks])
    plan = ColorPlan(color=-1, kmax=int(cv_card.max()), amax=amax,
                     cv_vid=cv_vid, cv_card=cv_card,
                     cv_isev=np.zeros(len(cv_vid), np.int32),
                     cv_valid=valid, **it)
    return MessagePlan(
        pd=plan_tensors(plan, device),
        present=present_types_of(it["it_ftype"]),
        scatter_vid=[torch.as_tensor(b["tvids"], device=device)
                     for b in blocks],
        row0=[int(r) for r in row0])


def _add_messages(ext: torch.Tensor, mp: MessagePlan, m: torch.Tensor,
                  put=lambda t: t) -> None:
    """Add each block's messages ``m`` rows into ``ext`` at its targets,
    blocks in order (each block has each target once)."""
    for tgt, r0 in zip(mp.scatter_vid, mp.row0):
        ext.index_add_(0, put(tgt), put(m[r0:r0 + len(tgt)]))


def _part_views(weights, variables, factors, fmap, part, mode,
                domain_mask, max_colors, seed):
    """Per part: (owned mask, compiled graph, owned factor ids). A part
    compiles the factors it keeps (values: those touching an owned
    variable; messages: those it owns) with its non-owned variables
    frozen (isEvidence=4)."""
    F = len(factors)
    arity = factors["arity"].astype(np.int64)
    fvid = fmap["vid"].astype(np.int64)
    edge_fid = np.repeat(np.arange(F, dtype=np.int64), arity)
    edge_part = part[fvid]
    owner = factor_owner(factors, fmap, part)
    n_parts = int(part.max()) + 1 if len(part) else 1
    out = []
    for p in range(n_parts):
        owned_vars = part == p
        if mode == "values":
            touches = np.zeros(F, bool)
            np.logical_or.at(touches, edge_fid, edge_part == p)
            skip = np.flatnonzero(~touches).astype(np.int64)
        else:
            skip = np.flatnonzero(owner != p).astype(np.int64)
        v = variables.copy()
        v["isEvidence"] = np.where(owned_vars, variables["isEvidence"],
                                   np.int8(4))
        cg = compile_graph(weights, v, factors, fmap, factors_to_skip=skip,
                           max_colors=max_colors, domain_mask=domain_mask,
                           seed=seed)
        out.append((owned_vars, cg,
                    np.flatnonzero(owner == p).astype(np.int64)))
    return out


def _check_mode(mode: str) -> None:
    if mode not in ("values", "messages"):
        raise ValueError("mode must be 'values' or 'messages', not %r"
                         % (mode,))


class BSPEngine:
    """Partitioned Gibbs with per-sync boundary exchange (stale halos),
    each part on an ``ops/gibbs.GibbsEngine``.

    Parameters mirror ``NumbSkull.loadFactorGraph`` plus a variable
    partition. ``devices``: optional list of torch devices; part p runs on
    ``devices[p % len(devices)]`` and exchanges and weight-delta sums
    hop through ``devices[0]`` (the coordinator, the reference's master
    role). Without it every part runs on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; the reference's machines=0 baseline)."""

    def __init__(self, weights, variables, factors, fmap,
                 part: np.ndarray, mode: str = "values",
                 domain_mask=None, max_colors=None, seed: int = 0,
                 devices=None, device="cuda"):
        _check_mode(mode)
        self.mode = mode
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        part = np.asarray(part, np.int64)
        self.part = part
        self.n_parts = int(part.max()) + 1 if len(part) else 1
        self.n_vars = len(variables)
        self.seed = seed
        self.factor_owner = factor_owner(factors, fmap, part)

        self.engines: list[GibbsEngine] = []
        self.msg_plans: list[MessagePlan | None] = []
        self.owned_masks: list[np.ndarray] = []
        for p, (owned_vars, cg, owned_fids) in enumerate(_part_views(
                weights, variables, factors, fmap, part, mode, domain_mask,
                max_colors, seed)):
            self.owned_masks.append(owned_vars)
            self.engines.append(GibbsEngine(cg, device=self._dev(p)))
            self.msg_plans.append(_message_plan([_message_block(
                variables, factors, fmap, owned_fids,
                target_mask=~owned_vars, n_vars=self.n_vars)],
                self._dev(p)) if mode == "messages" else None)
        self.kmax = self.engines[0].kmax
        # ownership masks live at the coordinator (combine site)
        self._owned_dev = [torch.as_tensor(m, device=self._dev(0))
                           for m in self.owned_masks]

        # boundary variables: appear in a factor that straddles parts
        F = len(factors)
        fvid = fmap["vid"].astype(np.int64)
        edge_fid = np.repeat(np.arange(F, dtype=np.int64),
                             factors["arity"].astype(np.int64))
        edge_part = part[fvid]
        fac_min = np.full(F, self.n_parts, np.int64)
        fac_max = np.full(F, -1, np.int64)
        np.minimum.at(fac_min, edge_fid, edge_part)
        np.maximum.at(fac_max, edge_fid, edge_part)
        straddles = fac_min != fac_max
        bvar = np.zeros(self.n_vars, bool)
        bvar[fvid[straddles[edge_fid]]] = True
        self.boundary_vars = bvar

    def _dev(self, p: int) -> torch.device:
        return self.devices[p % len(self.devices)]

    def _put(self, x: torch.Tensor, p: int) -> torch.Tensor:
        return x.to(self._dev(p))

    @staticmethod
    def _seed(generator: torch.Generator) -> int:
        """A part's base seed for one sync, drawn from ``generator`` (the
        counterpart of the JAX engine's fold_in of the step and part)."""
        return int(torch.randint(1 << 62, (1,), generator=generator,
                                 device=generator.device))

    # --- state -------------------------------------------------------------

    def init_states(self) -> list[SamplerState]:
        return [eng.init_state() for eng in self.engines]

    # --- sync primitives (the exchange, reference §3.4) ---------------------

    def _global_values(self, states, attr: str) -> torch.Tensor:
        """Every variable's value from its owner part, at the
        coordinator."""
        out = self._put(getattr(states[0], attr), 0)
        for p in range(1, self.n_parts):
            out = torch.where(self._owned_dev[p],
                              self._put(getattr(states[p], attr), 0), out)
        return out

    def exchange(self, states) -> list[SamplerState]:
        """Refresh every part's ghost values from the owners."""
        gv = self._global_values(states, "var_value")
        ge = self._global_values(states, "var_value_evid")
        return [dataclasses.replace(s, var_value=self._put(gv, p),
                                    var_value_evid=self._put(ge, p))
                for p, s in enumerate(states)]

    def messages(self, states, chain: str = "var_value"):
        """(V, K) summed incoming boundary potential messages, reduced at
        the coordinator (parts added in order); None in values mode."""
        if self.mode != "messages":
            return None
        ext = torch.zeros((self.n_vars, self.kmax), dtype=torch.float32,
                          device=self._dev(0))
        for p, mp in enumerate(self.msg_plans):
            if mp is None:
                continue
            m = color_potentials(mp.pd, self.kmax, mp.present,
                                 getattr(states[p], chain),
                                 states[p].weight_value)
            _add_messages(ext, mp, m, lambda t: self._put(t, 0))
        return ext

    # --- epoch loops ---------------------------------------------------------

    def inference(self, states, generator: torch.Generator, epochs: int,
                  burn: int = 0, sample_evidence: bool = True,
                  sync_every: int = 1):
        """Burn-in then tallying epochs; ghosts/messages refresh every
        ``sync_every`` local epochs (the reference syncs every epoch)."""
        for phase, n in (("burn", burn), ("epoch", epochs)):
            done = 0
            while done < n:
                k = min(sync_every, n - done)
                ext = self.messages(states)
                states = [
                    eng.inference(
                        st, self._seed(generator),
                        epochs=0 if phase == "burn" else k,
                        burn=k if phase == "burn" else 0,
                        sample_evidence=sample_evidence,
                        ext_pot=None if ext is None else self._put(ext, p))
                    for p, (eng, st) in enumerate(zip(self.engines, states))
                ]
                states = self.exchange(states)
                done += k
        return states

    def learn(self, states, generator: torch.Generator, epochs: int,
              stepsize: float, decay: float = 1.0, burn: int = 0,
              lp: LearnParams = LearnParams()):
        """Distributed SGD: per-sync local epoch, weight deltas summed
        across parts (the reference's parameter-server reduction,
        numbskull_master.py:223-224), weights re-broadcast."""
        if burn:
            states = self.inference(states, generator, epochs=0, burn=burn,
                                    sample_evidence=True)
        w_global = self._put(states[0].weight_value, 0)
        states = [dataclasses.replace(s, weight_value=self._put(w_global, p))
                  for p, s in enumerate(states)]
        for e in range(epochs):
            ext = self.messages(states)
            ext_e = self.messages(states, "var_value_evid")
            step = stepsize * (decay ** e)
            new_states = []
            dw_sum = torch.zeros_like(w_global)
            for p, (eng, st) in enumerate(zip(self.engines, states)):
                st2 = eng.learn(
                    st, self._seed(generator), epochs=1,
                    stepsize=step, decay=1.0, burn=0, lp=lp,
                    ext_pot=None if ext is None else self._put(ext, p),
                    ext_pot_evid=(None if ext_e is None
                                  else self._put(ext_e, p)))
                dw_sum = dw_sum + (self._put(st2.weight_value, 0) - w_global)
                new_states.append(st2)
            w_global = w_global + dw_sum
            states = [dataclasses.replace(
                s, weight_value=self._put(w_global, p))
                for p, s in enumerate(new_states)]
            states = self.exchange(states)
        return states

    # --- results -------------------------------------------------------------

    def marginals(self, states, epochs: int) -> np.ndarray:
        """(V, K) marginals: each variable's tally from its owner part."""
        cnt = self._put(states[0].count, 0)
        for p in range(1, self.n_parts):
            cnt = torch.where(self._owned_dev[p][:, None],
                              self._put(states[p].count, 0), cnt)
        return cnt.cpu().numpy() / float(max(epochs, 1))

    def weights(self, states) -> np.ndarray:
        return states[0].weight_value.cpu().numpy()

    # --- traffic accounting (the PF/UFO bandwidth claim, quantified) ---------

    def sync_traffic(self) -> dict:
        """Per-sync payload sizes in scalar counts: boundary variable
        values (values mode ships each once) vs message floats (messages
        mode ships kmax floats per (sender part, target var) pair)."""
        msg_floats = sum(mp.n_targets * self.kmax
                         for mp in self.msg_plans if mp is not None)
        return {"mode": self.mode,
                "boundary_values_per_sync": int(self.boundary_vars.sum()),
                "message_floats_per_sync": msg_floats}


@dataclasses.dataclass
class BSPState:
    """The global state of a :class:`BSPItemGridInference`, on one
    device: both chains in variable order, the weights and the owners'
    tallies."""

    values: torch.Tensor        # (V,) int32 free chain
    values_evid: torch.Tensor   # (V,) int32 clamped chain
    weights: torch.Tensor       # (W,) float32
    counts: torch.Tensor        # (V, K) int64 tallies


class BSPItemGridInference:
    """Bulk-synchronous partitioned inference and learning with the fused
    itemgrid kernels as local engines: the reference's cluster semantics
    (stale halos, per-sync exchange) at kernel speed, every part on
    ``device`` (``cuda`` unless the caller asks for ``cpu``).

    Modes (as BSPEngine):
    - ``values``: straddling factors replicated on every part touching
      them; ghost values refresh at syncs. Inference only (a replicated
      factor would double-count gradients).
    - ``messages``: every factor lives on its owner part; parts receive
      per-value boundary potential messages instead, fed to the kernels'
      has_ext forms. Supports learning: each factor's gradient is counted
      exactly once.

    Seeds as the JAX class's, each wrapped to int32: inference ``seed +
    7919 * sync + part``, learning ``seed + 104729 * epoch + part``, the
    learning burn-in ``seed ^ 0x5EED``. ``schedules``: optional per-part
    ``ops/itemgrid.Schedule`` (default: each part's own). ``plain=True``
    on ``inference`` and ``learn`` runs the kernels' plain versions on
    the engine's device (how ``chip_smoke.py`` holds the kernels to
    them on the card)."""

    def __init__(self, weights, variables, factors, fmap,
                 part: np.ndarray, mode: str = "values",
                 domain_mask=None, seed: int = 0, device="cuda",
                 schedules=None):
        _check_mode(mode)
        self.mode = mode
        self.device = torch.device(device)
        part = np.asarray(part, np.int64)
        self.part = part
        self.n_parts = int(part.max()) + 1 if len(part) else 1
        self.n_vars = len(variables)

        self.engines: list[ItemGridEngine] = []
        self.owned: list[torch.Tensor] = []
        blocks = []
        for p, (owned_vars, cg, owned_fids) in enumerate(_part_views(
                weights, variables, factors, fmap, part, mode, domain_mask,
                None, seed)):
            self.owned.append(torch.as_tensor(owned_vars,
                                              device=self.device))
            self.engines.append(ItemGridEngine(
                cg, device=self.device,
                schedule=None if schedules is None else schedules[p]))
            if mode == "messages":
                blocks.append(_message_block(
                    variables, factors, fmap, owned_fids,
                    target_mask=~owned_vars, n_vars=self.n_vars))
        # every part's messages in one plan: one color_potentials call
        self.msg_plan = _message_plan(blocks, self.device)
        self.kmax = max(e.cg.kmax for e in self.engines)
        init = torch.as_tensor(
            variables["initialValue"].astype(np.int32), device=self.device)
        self.state = BSPState(
            values=init, values_evid=init.clone(),
            weights=torch.as_tensor(
                np.asarray(weights["initialValue"], np.float32),
                device=self.device),
            counts=torch.zeros((self.n_vars, self.kmax), dtype=torch.int64,
                               device=self.device))

    def _messages(self, values: torch.Tensor):
        """(V, K) summed incoming boundary potential messages computed
        from a global chain ``values``: every part's messages in one
        ``color_potentials`` call, each part's added with ``index_add_``,
        parts in order (one term per part and target); None in values
        mode."""
        if self.mode != "messages":
            return None
        ext = torch.zeros((self.n_vars, self.kmax), dtype=torch.float32,
                          device=self.device)
        mp = self.msg_plan
        if mp is not None:
            _add_messages(ext, mp, color_potentials(
                mp.pd, self.kmax, mp.present, values, self.state.weights))
        return ext

    def _sweep_parts(self, seed: int, burn: int, epochs: int, ext,
                     plain: bool = False):
        """Every part's local run from the global chain: [(values,
        counts)] per part."""
        st = self.state
        return [eng.run(_i32(seed + p), burn=burn, epochs=epochs,
                        x0=st.values, weight_value=st.weights, ext_pot=ext,
                        plain=plain)
                for p, eng in enumerate(self.engines)]

    def _exchange(self, outs, tally: bool) -> None:
        """The owners' values become the global chain; with ``tally``,
        the owners' counts add into the global tallies."""
        st = self.state
        new = st.values
        for own, (vals, counts) in zip(self.owned, outs):
            new = torch.where(own, vals, new)
            if tally:
                K = counts.shape[1]
                st.counts[:, :K] += torch.where(own[:, None], counts, 0)
        st.values = new

    def inference(self, seed: int, epochs: int, burn: int = 0,
                  sync_every: int = 1, plain: bool = False) -> torch.Tensor:
        """Burn-in then tallying epochs; owned values (and messages in
        messages mode) exchange at every sync (reference
        numbskull_master.py:151-227). Returns the global chain."""
        step = 0
        for phase, n in (("burn", burn), ("epoch", epochs)):
            done = 0
            while done < n:
                k = min(sync_every, n - done)
                ext = self._messages(self.state.values)
                outs = self._sweep_parts(
                    seed + 7919 * step, burn=k if phase == "burn" else 0,
                    epochs=0 if phase == "burn" else k, ext=ext,
                    plain=plain)
                self._exchange(outs, phase == "epoch")
                done += k
                step += 1
        return self.state.values

    def _learn_parts(self, seed: int, e: int, step: float, lp, ext, ext_e,
                     plain: bool = False):
        """Every part's learning epoch ``e`` from the global state:
        [(weights, free chain, clamped chain)] per part."""
        st = self.state
        return [eng.learn(_i32(seed + 104729 * e + p), burn=0, epochs=1,
                          stepsize=step, decay=1.0, lp=lp,
                          weight_value=st.weights, x0=st.values,
                          xe0=st.values_evid, ext_pot=ext,
                          ext_pot_evid=ext_e, plain=plain)
                for p, eng in enumerate(self.engines)]

    def _learn_exchange(self, outs) -> None:
        """The parts' weight deltas summed in part order onto the global
        weights (float32); the owners' values of both chains become the
        global chains."""
        st = self.state
        w_global = st.weights
        dw = torch.zeros_like(w_global)
        new_v, new_ve = st.values, st.values_evid
        for own, (w, x, xe) in zip(self.owned, outs):
            dw += w - w_global
            new_v = torch.where(own, x, new_v)
            new_ve = torch.where(own, xe, new_ve)
        st.weights = w_global + dw
        st.values, st.values_evid = new_v, new_ve

    def learn(self, seed: int, epochs: int, stepsize: float,
              decay: float = 1.0, burn: int = 0, lp=None,
              plain: bool = False) -> torch.Tensor:
        """Distributed in-kernel SGD (messages mode): per-sync local
        epoch with boundary messages for both chains, weight deltas
        summed across parts in part order and re-broadcast (the
        reference's parameter-server reduction, numbskull_master.py:
        223-224). Returns the learned weights."""
        if self.mode != "messages":
            raise ValueError(
                "BSP itemgrid learning requires messages mode (a values-"
                "mode replicated factor would double-count gradients)")
        st = self.state
        if burn:
            self.inference(seed ^ 0x5EED, epochs=0, burn=burn, plain=plain)
            st.values_evid = st.values.clone()
        for e in range(epochs):
            ext = self._messages(st.values)
            ext_e = self._messages(st.values_evid)
            self._learn_exchange(self._learn_parts(
                seed, e, stepsize * (decay ** e), lp, ext, ext_e, plain))
        return st.weights

    def marginals(self, epochs: int) -> np.ndarray:
        return self.state.counts.cpu().numpy().astype(np.float64) / \
            float(max(epochs, 1))
