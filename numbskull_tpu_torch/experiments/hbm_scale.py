"""Scaling of ``engine="hbm"``: throughput against graph size.

Port of ``experiments/hbm_scale.py``: the Ising ladder 160x512,
1024x2048, 4096x4096 and 4096x8192 (33,554,432 variables), each through
``compile_graph`` (with the lattice's color hint) and the engine of
``FactorGraph(cg, engine="hbm")``, whose kernels keep every graph in
device memory. A short run checks the marginals first (an unbiased
lattice hovers around 0.5). The TPU engine split its value slabs between
VMEM and HBM (``sr_rows``); the port has no such split and writes ``-``
there.

The port adds ``engine_build_s`` (the sweep tables' build and upload)
and reports the median of 3 epoch-differenced rates (CUDA events) with
their spread (``updates_per_s_spread``, largest minus smallest).

Usage: python -m numbskull_tpu_torch.experiments.hbm_scale [out.tsv]
           [--device cuda|cpu]
"""

from __future__ import annotations

import time

import torch

from numbskull_tpu_torch.benchutil import median_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import ising_color_hint, ising_grid
from numbskull_tpu_torch.numbskull import FactorGraph

GRIDS = ((160, 512), (1024, 2048), (4096, 4096), (4096, 8192))
HEADER = ["n_vars", "grid", "sr_rows", "compile_s", "epoch_ms",
          "updates_per_s", "engine_build_s", "updates_per_s_spread",
          "engine"]


def run(out_path: str = "hbm_scale.tsv", grids=GRIDS, device="cuda",
        points=None):
    """Every grid; ``points`` (lo, hi) replaces the JAX driver's epoch
    counts (tests). Writes and returns the rows."""
    device = torch.device(device)
    rows = []
    for n, m in grids:
        t0 = time.perf_counter()
        w, v, f, fm, dm, _ = ising_grid(n, m, weight=0.3)
        cg = compile_graph(w, v, f, fm, domain_mask=dm,
                           color_hint=ising_color_hint(n, m))
        compile_s = time.perf_counter() - t0
        fg = FactorGraph(cg, 0, device=device, engine="hbm")
        t0 = time.perf_counter()
        eng = fg.engine(True)
        common.sync(device)
        build_s = time.perf_counter() - t0
        engine = type(eng).__name__

        def runner(ep, r):
            return eng.run(1 + r, 0, ep)

        _, counts = runner(8, 8)
        marg = float(counts[:, 1].double().mean()) / 8
        if not 0.2 < marg < 0.8:
            raise RuntimeError("%dx%d: mean marginal %.3f outside (0.2, "
                               "0.8)" % (n, m, marg))
        lo, hi = points or ((4, 40) if n * m > 4e6 else (16, 1500))
        ups, spread, per = median_rate(runner, n * m, lo, hi, n=3,
                                       device=device)
        rows.append([n * m, "%dx%d" % (n, m), "-", "%.2f" % compile_s,
                     "%.4f" % (1e3 * per), "%.4e" % ups, "%.2f" % build_s,
                     "%.4e" % spread, engine])
        print("\t".join(str(c) for c in rows[-1]), flush=True)
        del fg, eng, runner, counts
        if device.type == "cuda":
            torch.cuda.empty_cache()
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "hbm_scale.tsv").parse_args(argv)
    run(args.out, device=args.device)


if __name__ == "__main__":
    main()
