"""The (chains, graph) mesh of ``parallel/sharded.ShardedGibbsEngine``.

Port of ``numbskull_tpu/parallel/mesh.py``. Two axes, as there:

- ``chains``: the replica axis, independent Gibbs chains (the reference's
  var_copies, reference factorgraph.py:48-53). Tallies reduce across it;
  learning gradients are averaged across it.
- ``graph``: the model-parallel axis. Factor work items are split into
  shards; each shard computes partial potentials from its own items and
  a sum over the axis gives every shard the full potentials (exact
  synchronous chromatic Gibbs at any shard count).

Where the JAX package lays the axes over a device mesh, a port mesh runs
either in one process, every chain and every shard on one device (the
counterpart of the JAX tests' 8-device virtual CPU mesh), or over a
``torch.distributed`` group with one (chain, shard) per process, the
graph and chains axes being subgroups of it.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

CHAINS_AXIS = "chains"
GRAPH_AXIS = "graph"

#: how long any collective of a group made here (or by
#: ``multihost.initialize``) waits for its peers before it raises
TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (chains, graph) mesh and this process's place in it.

    ``chains`` and ``shards`` are the chain indices and graph shards this
    process runs: all of them in process, one each over a group. Over a
    group, ``graph_group`` joins the processes of this process's chain
    and ``chains_group`` those of its graph shard (both None in
    process)."""

    n_chains: int
    n_graph: int
    device: torch.device
    chains: tuple
    shards: tuple
    graph_group: object = None
    chains_group: object = None

    @property
    def shape(self) -> dict:
        return {CHAINS_AXIS: self.n_chains, GRAPH_AXIS: self.n_graph}


def make_mesh(n_chains: int = 1, n_graph: int | None = None, group=None,
              device="cuda") -> Mesh:
    """A (chains, graph) mesh on ``device`` (``cuda`` unless the caller
    asks for ``cpu``).

    Without ``group`` the whole mesh runs in this process (``n_graph``
    None means 1). With a ``torch.distributed`` group of size
    ``n_chains * n_graph`` (``n_graph`` None means size // n_chains),
    group rank r is chain r // n_graph and graph shard r % n_graph; every
    process of the job must call this, in the same order, because each
    creates every subgroup (``dist.new_group``'s rule)."""
    device = torch.device(device)
    if group is None:
        n_graph = 1 if n_graph is None else n_graph
        if n_chains < 1 or n_graph < 1:
            raise ValueError("mesh shape (%d, %d)" % (n_chains, n_graph))
        return Mesh(n_chains, n_graph, device, tuple(range(n_chains)),
                    tuple(range(n_graph)))
    size = dist.get_world_size(group)
    if n_graph is None:
        if n_chains < 1 or size % n_chains:
            raise ValueError("%d processes do not split into %d chains"
                             % (size, n_chains))
        n_graph = size // n_chains
    if n_chains < 1 or n_graph < 1 or n_chains * n_graph != size:
        raise ValueError("mesh shape (%d, %d) does not fill a group of %d"
                         % (n_chains, n_graph, size))
    ranks = dist.get_process_group_ranks(group)
    chain, shard = divmod(dist.get_rank(group), n_graph)
    graph_group = chains_group = None
    for c in range(n_chains):
        g = dist.new_group([ranks[c * n_graph + s] for s in range(n_graph)],
                           timeout=TIMEOUT)
        if c == chain:
            graph_group = g
    for s in range(n_graph):
        g = dist.new_group([ranks[c * n_graph + s] for c in range(n_chains)],
                           timeout=TIMEOUT)
        if s == shard:
            chains_group = g
    return Mesh(n_chains, n_graph, device, (chain,), (shard,), graph_group,
                chains_group)
