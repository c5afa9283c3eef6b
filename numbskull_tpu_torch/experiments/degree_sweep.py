"""Degree-scaling experiment: throughput against factor degree.

Port of ``experiments/degree_sweep.py`` (the reference's flagship
scaling experiment, salt/src/experiment_intro_degree.py:9-88: 1.26 M
variables in ``n_vars // degree`` disjoint voting groups, one
proposition and ``degree`` voters under one AND factor). Each degree
runs on ``ItemGridEngine`` (the sweep and learn kernels), or, when the
kernels refuse the graph (``ops/itemgrid.EnvelopeError``), on the
tensor-op ``GibbsEngine``, as the CLI does; ``engine`` says which
(``itemgrid`` or ``gibbs``, the JAX driver's ``xla``). Rates are
epoch-differenced (``benchutil.epoch_rate``, CUDA events).

The port adds the learning side: ``learn_epoch_ms`` and
``learn_updates_per_s`` (a learning epoch counts every variable once,
as ``bench.py`` does). So that learning has gradients to take, the
graph's weight is learnable and 30 % of its variables are evidence; the
inference rate is unaffected (inference resamples evidence too, as the
JAX driver's engine does). Compiles go through the on-disk plan cache
when ``NSX_PLAN_CACHE`` names one.

Usage: python -m numbskull_tpu_torch.experiments.degree_sweep [out.tsv]
           [n_vars] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import time

import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import voting_grouped
from numbskull_tpu_torch.ops.gibbs import GibbsEngine
from numbskull_tpu_torch.ops.itemgrid import EnvelopeError, ItemGridEngine

DEGREES = (1, 2, 5, 10, 20, 35, 50)
HEADER = ["degree", "n_vars", "n_colors", "engine", "compile_s",
          "epoch_ms", "updates_per_s", "learn_epoch_ms",
          "learn_updates_per_s"]


def build_engine(cg, device) -> tuple:
    """(engine name, engine): ItemGridEngine, or GibbsEngine for a graph
    outside the kernels' envelope (and only then)."""
    try:
        return "itemgrid", ItemGridEngine(cg, device=device)
    except EnvelopeError as err:
        print("itemgrid fallback (%s)" % err, flush=True)
        return "gibbs", GibbsEngine(cg, device=device)


def runners(eng) -> tuple:
    """(inference runner, learning runner) of ``eng`` for epoch_rate:
    ``run(epochs, rep)``."""
    if isinstance(eng, ItemGridEngine):
        return (lambda ep, r: eng.run(1 + r, 0, ep),
                lambda ep, r: eng.learn(1 + r, 0, ep, 0.01))
    st = eng.init_state()
    return (lambda ep, r: eng.inference(st, 1 + r, ep),
            lambda ep, r: eng.learn(st, 1 + r, ep, 0.01))


def run(out_path: str = "degree_sweep.tsv", n_vars: int = 1_260_000,
        degrees=DEGREES, device="cuda", points=((16, 1500), (4, 200))):
    """Every degree; ``points`` are the (lo, hi) epoch counts of the
    inference and learning rates. Writes and returns the rows."""
    device = torch.device(device)
    cache = os.environ.get("NSX_PLAN_CACHE") or None
    rows = []
    for degree in degrees:
        w, v, f, fm, dm, _ = voting_grouped(n_vars, degree, weight=0.3,
                                            fixed=False, seed=1,
                                            evidence_frac=0.3)
        V = len(v)
        t0 = time.perf_counter()
        cg = compile_graph(w, v, f, fm, domain_mask=dm, cache=cache)
        compile_s = time.perf_counter() - t0
        engine, eng = build_engine(cg, device)
        infer, learn = runners(eng)
        ups, per = epoch_rate(infer, V, *points[0], device=device)
        lups, lper = epoch_rate(learn, V, *points[1], device=device)
        rows.append([degree, V, cg.n_colors, engine, "%.2f" % compile_s,
                     "%.4f" % (1e3 * per), "%.4e" % ups,
                     "%.4f" % (1e3 * lper), "%.4e" % lups])
        print("\t".join(str(c) for c in rows[-1]), flush=True)
        del eng, infer, learn
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "degree_sweep.tsv")
    p.add_argument("n_vars", nargs="?", type=int, default=1_260_000)
    args = p.parse_args(argv)
    run(args.out, args.n_vars, device=args.device)


if __name__ == "__main__":
    main()
