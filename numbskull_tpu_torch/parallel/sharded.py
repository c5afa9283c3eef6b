"""Chromatic Gibbs over a (chains, graph) mesh: chain replication times
graph sharding.

Port of ``numbskull_tpu/parallel/sharded.py`` (the JAX package's
replacement for the reference's salt master/minion stack, reference:
salt/src/numbskull_master.py:133-233, salt/src/messages.py:1253-1319),
in tensor ops over the pieces of ``ops/gibbs``, with the collectives of
``torch.distributed`` where the JAX engine runs ``shard_map``:

* Each color plan's items are split into ``n_graph`` contiguous shards
  (the JAX split points, item order kept within a shard). Per color a
  shard computes partial potentials (R, kmax) from its own items; the
  sum over the ``graph`` axis (in shard order in one process, an
  ``all_reduce`` over the chain's graph subgroup across processes) gives
  the full potentials, and every shard of a chain draws the same values
  from the chain's generator, so values stay replicated with no
  exchange of values: exact synchronous chromatic Gibbs at any shard
  count. The JAX engine pads every shard to one item count; a port
  shard's partial is (R, kmax) whatever its item count, so there are no
  pad items.
* Chains: chain c draws from generators seeded by
  ``epoch_seed(chain_seed(seed, c), tag, epoch)``, ``GibbsEngine``'s
  streams under the base seed ``chain_seed(seed, c)`` (which does not
  depend on the chain count). Tallies are kept per chain and pooled in
  ``marginals``. Learning sums each chain's per-weight gradients over
  ``graph`` and averages them over ``chains`` (the JAX ``psum`` and
  ``pmean``, the reference's master-side weight-delta sum), so every
  chain steps the same weights.
* The L1 truncation coin draws from a stream of its own,
  ``epoch_seed(seed, COIN_TAG, epoch)``, with no chain index in it: the
  weights stay bit-identical on every chain and every process. (The JAX
  engine draws it from a chain-folded key, which makes the weights
  chain-varying where its ``out_specs`` declare them replicated: its L1
  learning on a mesh fails to trace.)

Chains step in lockstep, color by color, because a learning color step
needs every chain's gradient. In one process the whole mesh runs on
``mesh.device``; over a group (``make_mesh(..., group=...)``) this
process runs one (chain, shard), and its state holds its chain only.
Under ``nccl`` the collectives run on the device; under ``gloo`` each
goes through host memory (copy out, ``all_reduce``, copy back).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from numbskull_tpu_torch.compile import CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import present_types_of
from numbskull_tpu_torch.ops.gibbs import (
    BURN_TAG, EPOCH_TAG, LEARN_BURN_TAG, LEARN_TAG, LearnParams,
    color_potentials, epoch_seed, infer_store, learn_draws, learn_grads,
    step_plan, store_rows, update_weights,
)
from numbskull_tpu_torch.ops.sample import make_generator
from numbskull_tpu_torch.parallel.mesh import Mesh
from numbskull_tpu_torch.types import EV_EVIDENCE, EV_QUERY

#: ``epoch_seed`` tag of the L1 truncation coin (``ops/gibbs`` uses 0-3)
COIN_TAG = 4


def chain_seed(seed: int, chain: int) -> int:
    """Chain ``chain``'s base seed: ``SeedSequence([seed, chain])``, 64
    bits (``seed`` is taken modulo 2**64)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                 int(chain)])
    return int(ss.generate_state(1, np.uint64)[0])


def shard_items(n_items: int, n_graph: int, shard: int) -> np.ndarray:
    """The items of graph shard ``shard``: the contiguous split of the
    JAX engine (``_shard_items``: ceil(n / n_graph) items a shard, the
    last ones shorter), without its pad items."""
    per = -(-n_items // n_graph)
    return np.arange(min(shard * per, n_items),
                     min((shard + 1) * per, n_items))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``: in place on the device under nccl,
    through host memory otherwise."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(t, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, group=group)
    return host.to(t.device)


@dataclasses.dataclass
class ShardedState:
    """Sampler state with a leading axis over this process's chains
    (all of them in one process, one over a group)."""

    var_value: torch.Tensor        # (C, V) int32 free chains
    var_value_evid: torch.Tensor   # (C, V) int32 clamped chains
    weight_value: torch.Tensor     # (W,) float32, the same on every chain
    count: torch.Tensor            # (C, V, K) int32 tallies per chain


class ShardedGibbsEngine:
    """Chromatic Gibbs over a (chains, graph) mesh (``parallel/mesh``).

    ``inference`` and ``learn`` take an int base ``seed`` and an
    ``epoch_offset`` as ``GibbsEngine``'s do and return a new state.
    Over a group every method that steps or pools is a collective: every
    process of the mesh calls it with the same arguments."""

    def __init__(self, cg: CompiledGraph, mesh: Mesh):
        self.cg = cg
        self.mesh = mesh
        self.n_chains = mesh.n_chains
        self.n_graph = mesh.n_graph
        self.device = dev = mesh.device
        self.kmax = cg.kmax
        self.n_vars = cg.n_vars
        self.n_weights = cg.n_weights
        self.present = [present_types_of(p.it_ftype) for p in cg.plans]
        # per color, this process's shards' item plans (each with the
        # color's whole rows)
        self.plans = [[step_plan(p, dev, items=shard_items(
            len(p.it_row), self.n_graph, s)) for s in mesh.shards]
            for p in cg.plans]
        self.var_isev = torch.as_tensor(np.asarray(cg.var_isev, np.int64),
                                        device=dev)
        self.var_init = torch.as_tensor(np.asarray(cg.var_init, np.int32),
                                        device=dev)
        self.weight_fixed = torch.as_tensor(
            np.asarray(cg.weight_fixed, bool), device=dev)

    def init_state(self) -> ShardedState:
        C = len(self.mesh.chains)
        v0 = self.var_init[None].repeat(C, 1)
        return ShardedState(
            var_value=v0, var_value_evid=v0.clone(),
            weight_value=torch.as_tensor(
                np.asarray(self.cg.weight_init, np.float32),
                device=self.device),
            count=torch.zeros((C, self.n_vars, self.kmax),
                              dtype=torch.int32, device=self.device))

    # ---- the two axes' sums -----------------------------------------------

    def _graph_sum(self, parts: list) -> torch.Tensor:
        """Sum over the graph axis of this process's shards' partials
        (in shard order), then over the chain's graph subgroup."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        if self.mesh.graph_group is not None:
            out = _all_reduce(out, self.mesh.graph_group)
        return out

    def _chains_mean(self, per_chain: list) -> torch.Tensor:
        """Mean over the chains axis (the JAX ``pmean``: the sum, in
        chain order, divided by the chain count)."""
        out = per_chain[0]
        for t in per_chain[1:]:
            out = out + t
        if self.mesh.chains_group is not None:
            out = _all_reduce(out, self.mesh.chains_group)
        return out / self.n_chains

    # ---- sweeps -----------------------------------------------------------

    def _generators(self, seeds: list, tag: int, index: int) -> list:
        return [make_generator(epoch_seed(s, tag, index), self.device)
                for s in seeds]

    def _sweep(self, sample_evidence, vv, w, gens) -> None:
        """One inference sweep of every chain here, in place."""
        for shards, present in zip(self.plans, self.present):
            for j, gen in enumerate(gens):
                pot = self._graph_sum([color_potentials(
                    pd, self.kmax, present, vv[j], w) for pd in shards])
                infer_store(shards[0], pot, sample_evidence, vv[j], gen)

    def _color_learn(self, shards, present, lp, vv, ve, w, step, gens,
                     coin) -> torch.Tensor:
        """One learning color step of every chain here, in lockstep:
        draws, gradients summed over graph and averaged over chains, one
        weight update, then the stores. Returns the new weights."""
        rows = shards[0]
        R, W = rows["cv_card"].shape[0], self.n_weights
        vals, grads = [], []
        for j, gen in enumerate(gens):
            pots = self._graph_sum([torch.cat([
                color_potentials(pd, self.kmax, present, ve[j], w),
                color_potentials(pd, self.kmax, present, vv[j], w)])
                for pd in shards])
            e_val, p_val = learn_draws(rows, pots[:R], pots[R:],
                                       self.var_init, vv[j], ve[j], gen)
            grads.append(self._graph_sum([torch.cat(learn_grads(
                pd, present, lp, W, self.weight_fixed, vv[j], ve[j], e_val,
                p_val)) for pd in shards]))
            vals.append((e_val, p_val))
        g = self._chains_mean(grads)
        w = update_weights(w, g[:W], g[W:], lp, step, coin)
        for j, (e_val, p_val) in enumerate(vals):
            store_rows(vv[j], rows, p_val)
            store_rows(ve[j], rows, e_val)
        return w

    def _chain_seeds(self, seed: int) -> list:
        return [chain_seed(seed, c) for c in self.mesh.chains]

    def inference(self, state: ShardedState, seed: int, epochs: int,
                  burn: int = 0, sample_evidence: bool = True,
                  epoch_offset: int = 0) -> ShardedState:
        """Burn in, then run ``epochs`` tallying sweeps of every free
        chain; ``epoch_offset`` is the absolute index of the first
        tallied epoch."""
        seeds = self._chain_seeds(seed)
        vv = state.var_value.clone()
        w = state.weight_value
        for i in range(burn):
            self._sweep(sample_evidence, vv, w,
                        self._generators(seeds, BURN_TAG, i))
        cnt = state.count.clone()
        isev = self.var_isev
        mask = (isev == EV_QUERY) | (bool(sample_evidence) &
                                     (isev == EV_EVIDENCE))
        ks = torch.arange(self.kmax, device=self.device)
        for i in range(epochs):
            self._sweep(sample_evidence, vv, w, self._generators(
                seeds, EPOCH_TAG, epoch_offset + i))
            cnt += ((vv[:, :, None] == ks) &
                    mask[:, None]).to(cnt.dtype)
        return dataclasses.replace(state, var_value=vv, count=cnt)

    def learn(self, state: ShardedState, seed: int, epochs: int,
              stepsize: float, decay: float = 1.0, burn: int = 0,
              lp: LearnParams = LearnParams(),
              epoch_offset: int = 0) -> ShardedState:
        """Dual-chain SGD on every chain (burn-in samples evidence);
        epoch i steps at ``stepsize * decay**i`` and draws from the
        streams of epoch ``epoch_offset + i``."""
        seeds = self._chain_seeds(seed)
        vv = state.var_value.clone()
        ve = state.var_value_evid.clone()
        w = state.weight_value
        for i in range(burn):
            self._sweep(True, vv, w,
                        self._generators(seeds, LEARN_BURN_TAG, i))
        for i in range(epochs):
            step = float(np.float32(stepsize) *
                         np.power(np.float32(decay), np.float32(i)))
            gens = self._generators(seeds, LEARN_TAG, epoch_offset + i)
            coin = make_generator(epoch_seed(seed, COIN_TAG,
                                             epoch_offset + i), self.device)
            for shards, present in zip(self.plans, self.present):
                w = self._color_learn(shards, present, lp, vv, ve, w, step,
                                      gens, coin)
        return dataclasses.replace(state, var_value=vv, var_value_evid=ve,
                                   weight_value=w)

    def marginals(self, state: ShardedState, epochs: int) -> np.ndarray:
        """(V, K) marginals pooled over all chains (over a group, the
        counts are summed over the chains subgroup first, exactly)."""
        total = state.count.to(torch.int64).sum(0)
        if self.mesh.chains_group is not None:
            total = _all_reduce(total, self.mesh.chains_group)
        return total.cpu().numpy().astype(np.float64) / float(
            max(epochs, 1) * self.n_chains)
