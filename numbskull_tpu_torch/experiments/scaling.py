"""Chain and graph axis scaling of the mesh engine.

Port of ``experiments/scaling.py`` (the reference's machine-scaling
experiment, salt/src/experiment.py:8-26, re-targeted at mesh axes): the
(chains, graph) shapes (1, N), (2, N/2), ..., (N, 1) over N = 8 (the
JAX driver's 8-device CPU mesh) of ``ShardedGibbsEngine`` on a
128x128 Ising (weight 0.3), each as an in-process mesh on one device:
ms per epoch and total variable updates per second (chains multiply the
updates), with the efficiency against the first shape. On one device
the shards and chains run one after another, so the efficiency is the
cost of splitting the work, not a speed-up. Rates are epoch-differenced
(CUDA events) between 2 epochs and the JAX driver's 50, raised until
the difference takes 0.05 s.

Usage: python -m numbskull_tpu_torch.experiments.scaling [out.tsv]
           [grid_n] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import ising_color_hint, ising_grid
from numbskull_tpu_torch.parallel.mesh import make_mesh
from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine

HEADER = ["chains", "graph", "epoch_ms", "total_updates_per_s",
          "efficiency"]


def shapes(n_dev: int) -> list:
    """(chains, graph) with chains 1, 2, 4, ... up to ``n_dev``."""
    out, c = [], 1
    while c <= n_dev:
        out.append((c, n_dev // c))
        c *= 2
    return out


def run(out_path: str = "scaling.tsv", n: int = 128, device="cuda",
        n_dev: int = 8, points=None) -> list:
    """Every shape over ``n_dev``; ``points`` (lo, hi) replaces the
    epoch counts, with no raise (tests). Writes and returns the rows."""
    device = torch.device(device)
    w, v, f, fm, dm, _ = ising_grid(n, n, weight=0.3)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    rows, base = [], None
    for nc, ng in shapes(n_dev):
        eng = ShardedGibbsEngine(cg, make_mesh(nc, ng, device=device))
        st = eng.init_state()
        ups, per = epoch_rate(lambda ep, r: eng.inference(st, 1 + r, ep),
                              n * n * nc, *(points or (2, 50)),
                              device=device,
                              min_delta=0.0 if points else 0.05)
        base = ups if base is None else base
        rows.append([nc, ng, "%.4f" % (per * 1e3), "%.0f" % ups,
                     "%.3f" % (ups / base)])
        print("\t".join(str(c) for c in rows[-1]), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "scaling.tsv")
    p.add_argument("grid_n", nargs="?", type=int, default=128)
    args = p.parse_args(argv)
    run(args.out, args.grid_n, args.device)


if __name__ == "__main__":
    main()
