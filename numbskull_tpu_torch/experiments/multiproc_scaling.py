"""The cost of process boundaries: one fixed mesh owned by one process
or by one process per graph shard.

Port of ``experiments/multiproc_scaling.py`` (the reference's
machine-scaling experiment, salt/src/experiment.py:8-26): a fixed coin
graph (``n_copies`` copies, weights 0.5, -0.4, 0.3 fixed) on a fixed
(1, 2) and (1, 4) mesh of ``ShardedGibbsEngine``, each run two ways on
the one device: in one process (the in-process mesh, ``nproc`` 1) and
as 2 or 4 processes joined by a gloo group (``multihost.spawn``, one
shard each; the device is shared). The graph and the mesh are the same,
so ``vs_1proc``, the rate against the mesh's one-process row, is what
crossing process boundaries costs the per-color collectives; it is not
a multi-card number. A ``BSPEngine`` row (one process, 4 parts,
``messages`` mode, stale halos) is compared with the last mesh's
one-process row ((1, 4)), as the JAX driver compares it with the
exact-sync engine. Rates are epoch-differenced between fixed epoch
counts (2 and ``epochs``; CUDA events, in rank 0 of several processes),
fixed so that every process runs the same epochs.

Columns: the JAX driver's (``devs_per_proc`` is the graph shards a
process holds) and the port's ``mesh``.

Usage: python -m numbskull_tpu_torch.experiments.multiproc_scaling
           [out.tsv] [n_copies] [epochs] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.experiments._multiproc_prog import (graph, model,
                                                             run_rank)
from numbskull_tpu_torch.parallel import multihost
from numbskull_tpu_torch.parallel.bsp import BSPEngine
from numbskull_tpu_torch.parallel.mesh import make_mesh
from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine

HEADER = ["engine", "nproc", "devs_per_proc", "n_vars", "epoch_ms",
          "updates_per_s", "vs_1proc", "mesh"]


def _in_process(n_copies, n_graph, points, device) -> float:
    eng = ShardedGibbsEngine(graph(n_copies),
                             make_mesh(1, n_graph, device=device))
    st = eng.init_state()
    return epoch_rate(lambda ep, r: eng.inference(st, 1 + r, ep), 1,
                      *points, device=device, min_delta=0.0,
                      max_epochs=points[1])[1]


def _processes(n_copies, n_graph, points, device, timeout) -> float:
    with tempfile.TemporaryDirectory(prefix="nsx_mp_") as tmp:
        multihost.spawn(run_rank, n_graph,
                        (n_copies, points, str(device), tmp),
                        backend="gloo", timeout=timeout)
        return torch.load(os.path.join(tmp, "rank0.pt"))["per"]


def _bsp(n_copies, points, device) -> float:
    w, v, f, fm, dm, _ = model(n_copies)
    bsp = BSPEngine(w, v, f, fm, np.arange(len(v)) % 4, mode="messages",
                    domain_mask=dm, device=device)
    states = bsp.init_states()
    return epoch_rate(lambda ep, r: bsp.inference(
        states, torch.Generator().manual_seed(r), ep), 1, *points,
        device=device, min_delta=0.0, max_epochs=points[1])[1]


def run(out_path: str = "multiproc_scaling.tsv", n_copies: int = 4096,
        epochs: int = 60, device="cuda", meshes=(2, 4),
        timeout: float = 900.0) -> list:
    """The (1, G) meshes of ``meshes`` in one process and in G, then
    the BSP row. Writes and returns the rows."""
    device = torch.device(device)
    points = (2, epochs)
    V = 2 * n_copies
    rows, base = [], None

    def row(engine, nproc, per_proc, per, mesh):
        rows.append([engine, nproc, per_proc, V, "%.4f" % (per * 1e3),
                     "%.4e" % (V / per), "%.3f" % (base / per), mesh])
        print("\t".join(str(c) for c in rows[-1]), flush=True)

    for g in meshes:
        base = _in_process(n_copies, g, points, device)
        row("sharded", 1, g, base, "(1, %d)" % g)
        row("sharded", g, 1, _processes(n_copies, g, points, device,
                                        timeout), "(1, %d)" % g)
    row("bsp", 1, 4, _bsp(n_copies, points, device), "4 parts")
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "multiproc_scaling.tsv")
    p.add_argument("n_copies", nargs="?", type=int, default=4096)
    p.add_argument("epochs", nargs="?", type=int, default=60)
    args = p.parse_args(argv)
    run(args.out, args.n_copies, args.epochs, args.device)


if __name__ == "__main__":
    main()
