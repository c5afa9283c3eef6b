"""The fixed graph of ``multiproc_scaling`` and one process of its
multi-process rows.

Counterpart of ``experiments/_multiproc_prog.py``: started by
``multihost.spawn``, ``run_rank`` builds the driver's coin graph, lays a
(1, N) ``global_mesh`` over the N processes (one graph shard each) and
times ``ShardedGibbsEngine.inference`` epoch-differenced between fixed
epoch counts, the same in every process (the collectives need every
process to run the same epochs); rank 0 saves the time per epoch.
"""

from __future__ import annotations

import os

import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import coin_model
from numbskull_tpu_torch.parallel import multihost
from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine


def model(n_copies: int):
    """The JAX driver's coin graph: weights 0.5, -0.4, 0.3, fixed."""
    return coin_model(n_copies, 0.5, -0.4, 0.3, evidence=False,
                      weight_init=(0.5, -0.4, 0.3), fixed=True, seed=7)


def graph(n_copies: int):
    w, v, f, fm, dm, _ = model(n_copies)
    return compile_graph(w, v, f, fm, domain_mask=dm)


def run_rank(rank, group, n_copies: int, points, device, out_dir) -> None:
    eng = ShardedGibbsEngine(graph(n_copies),
                             multihost.global_mesh(1, device=device))
    st = eng.init_state()
    _, per = epoch_rate(lambda ep, r: eng.inference(st, 1 + r, ep),
                        1, *points, device=device, min_delta=0.0,
                        max_epochs=points[1])
    if multihost.is_coordinator():
        torch.save({"per": per, "shards": eng.n_graph},
                   os.path.join(out_dir, "rank0.pt"))
