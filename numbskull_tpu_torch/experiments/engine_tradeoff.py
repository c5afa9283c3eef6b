"""Engine tradeoff: which engine wins where.

Port of ``experiments/engine_tradeoff.py``: for each graph family and
size (Ising 128x128 and 512x512, coin 10k, the categorical LF model,
random voting at degree 10, grouped voting at degree 10 and 50), the
variable updates per second of the tensor-op ``GibbsEngine``
(``xla_ups``, the JAX driver's XLA engine) and of ``ItemGridEngine``
(the sweep kernel; ``fallback`` and the refusal in ``note`` when the
kernels refuse the graph), and for the Ising cases the port's
``lattice_ups`` (``GridGibbsEngine``, the lattice kernel, at the same
size and weight). Rates are epoch-differenced (CUDA events); the kernel
engines run up to the JAX driver's epoch count (``max(100, min(1000,
5e7 / n_vars))``), the tensor-op engine, which issues dozens of small
ops per color, 2 and 12 epochs (raised until the difference takes
0.05 s).

Usage: python -m numbskull_tpu_torch.experiments.engine_tradeoff
           [out.tsv] [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.experiments.degree_sweep import runners
from numbskull_tpu_torch.models import (coin_model, ising_color_hint,
                                       ising_grid, lf_model, voting_grouped,
                                       voting_model)
from numbskull_tpu_torch.ops.gibbs import GibbsEngine
from numbskull_tpu_torch.ops.itemgrid import EnvelopeError, ItemGridEngine
from numbskull_tpu_torch.ops.stencil import GridGibbsEngine

HEADER = ["graph", "n_vars", "n_colors", "xla_ups", "itemgrid_ups", "note",
          "lattice_ups"]


def cases(scale: float = 1.0) -> list:
    """(name, model, color hint, lattice side) of the JAX driver's
    cases; ``scale`` shrinks every size (for tests)."""
    def s(k):
        return max(int(k * scale), 2)
    out = []
    for n in (128, 512):
        n = s(n)
        out.append(("ising_%dx%d" % (n, n), ising_grid(n, n, weight=0.3),
                    ising_color_hint(n, n), n))
    out.append(("coin_10k", coin_model(s(5000), 0.3, -0.2, 0.4,
                                       evidence=False,
                                       weight_init=(0.3, -0.2, 0.4),
                                       fixed=True), None, None))
    out.append(("lf_categorical", lf_model(0.3, [0.9, 0.5],
                                           copies=s(2000), seed=0),
                None, None))
    out.append(("voting_rand_deg10", voting_model(s(16384), s(8192), 10,
                                                  weight=0.1, seed=1),
                None, None))
    for deg in (10, 50):
        out.append(("voting_grouped_deg%d" % deg,
                    voting_grouped(s(200_000), deg, weight=0.3), None,
                    None))
    return out


def run(out_path: str = "engine_tradeoff.tsv", device="cuda",
        scale: float = 1.0, epochs=None) -> list:
    """Every case; ``scale`` shrinks the graphs and ``epochs`` replaces
    every engine's largest epoch count (tests). Writes and returns the
    rows."""
    device = torch.device(device)
    rows = []
    for name, (w, v, f, fm, dm, _), hint, side in cases(scale):
        cg = compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint)
        V = cg.n_vars
        if epochs:                 # (lo, hi) of the tensor-op, kernel runs
            pts, delta = ((1, epochs), (1, epochs)), 0.0
        else:
            pts = ((2, 12), (16, max(100, min(1000, 50_000_000 // V))))
            delta = 0.05

        def rate(run, units, which):
            return "%.3e" % epoch_rate(run, units, *pts[which],
                                       device=device, min_delta=delta)[0]
        infer, _ = runners(GibbsEngine(cg, device=device))
        xla = rate(infer, V, 0)
        note = ""
        try:
            infer, _ = runners(ItemGridEngine(cg, device=device))
            item = rate(infer, V, 1)
        except EnvelopeError as err:
            item, note = "fallback", str(err)[:60]
        lattice = "-"
        if side is not None:
            g = GridGibbsEngine(side, side, 0.3, device=device)
            lattice = rate(lambda ep, r: g.run(1 + r, 0, ep), side * side, 1)
        rows.append([name, V, cg.n_colors, xla, item, note, lattice])
        print("\t".join(str(c) for c in rows[-1]), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "engine_tradeoff.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
