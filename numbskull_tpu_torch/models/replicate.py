"""Graph replication: independent sampler chains as disjoint copies.

The reference plumbs ``var_copies`` everywhere for replica chains but
always runs 1 (reference numbskull/factorgraph.py:48-53). Here chain
parallelism is expressed structurally: C disjoint copies of the graph
sharing one weight vector sample as ONE fused kernel run (or shard over
the ``chains`` mesh axis in parallel.sharded); marginals pool across
copies. Because copies are disjoint, the chromatic schedule and window
locality are preserved exactly.
"""

from __future__ import annotations

import numpy as np

from numbskull_tpu_torch import types as T


def replicate_graph(args, n_chains: int):
    """C disjoint copies of (weight, variable, factor, fmap, domain_mask,
    edges); weights are SHARED (same weightId space)."""
    w, v, f, fm, dm, e = args
    if n_chains <= 1:
        return args
    V, F, E = len(v), len(f), len(fm)
    v2 = np.tile(v, n_chains)
    f2 = np.tile(f, n_chains)
    fm2 = np.tile(fm, n_chains)
    for c in range(n_chains):
        fm2["vid"][c * E:(c + 1) * E] += c * V
        f2["ftv_offset"][c * F:(c + 1) * F] += c * E
    dm2 = None if dm is None else np.tile(np.asarray(dm, bool), n_chains)
    return w, v2, f2, fm2, dm2, E * n_chains


def pool_chain_counts(counts: np.ndarray, n_chains: int) -> np.ndarray:
    """Average (C*V, K) tallies over the chain axis -> (V, K)."""
    V = counts.shape[0] // n_chains
    return counts.reshape(n_chains, V, -1).mean(axis=0)
