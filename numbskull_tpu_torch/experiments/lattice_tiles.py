"""The lattice kernel's plans on the card: ms per sweep for each tile and
number of sweeps per launch tried, at each lattice size.

For each side (1024, 2048, 8192) and each candidate (tile rows, tile
cols, k, window rows a thread, 8-cell words a thread) it runs the kernel
(``ops/stencil_kernel._launch`` with that plan in place of
``lattice_plan``'s) from one initial lattice, times it
epoch-differenced with CUDA events (``benchutil.epoch_rate``), and checks
that x and count equal those of the plan ``lattice_plan`` picks (any
plan gives the same bits). The ``chosen`` column marks the plan that
``lattice_plan`` picks at the side's 250-sweep call. The table in
PERF.md comes from here; ``lattice_plan``'s table follows it.

It needs the card: a CPU device raises.

Usage: python -m numbskull_tpu_torch.experiments.lattice_tiles [out.tsv]
"""

from __future__ import annotations

import torch

from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.ops import stencil_kernel as sk

HEADER = ["side", "tile_rows", "tile_cols", "k", "rows_per_thread",
          "words_per_thread", "sweep_ms", "equal", "chosen"]
SIDES = (1024, 2048, 8192)
CANDIDATES = ((64, 64, 4, 2, 1), (64, 128, 4, 4, 1), (64, 128, 8, 2, 1),
              (64, 128, 8, 4, 1), (128, 128, 8, 8, 1), (128, 256, 8, 8, 1),
              (256, 128, 8, 8, 1), (256, 256, 8, 16, 1),
              (256, 256, 16, 16, 1), (64, 128, 8, 2, 2),
              (128, 256, 8, 4, 2), (128, 256, 8, 8, 2),
              (128, 256, 16, 8, 2), (256, 256, 8, 8, 2),
              (128, 512, 8, 8, 2), (256, 256, 8, 16, 2))
WEIGHT = 0.3


def run(out_path: str = "lattice_tiles.tsv", device="cuda", sides=SIDES,
        candidates=CANDIDATES, points=(16, 200)) -> list:
    """Every side and candidate; writes and returns the rows."""
    device = torch.device(device)
    common.device_line(device)
    if device.type != "cuda":
        raise RuntimeError("lattice_tiles times the CUDA kernel: it needs "
                           "device 'cuda'")
    rows = []
    for side in sides:
        x0 = sk.initial_lattice(1, side, side, device)
        want = sk.grid_gibbs(x0, 5, 3, 7, n=side, m=side, weight=WEIGHT,
                             bias=0.0)
        chosen = sk.lattice_plan(side, side, 250)[:5]
        for cand in candidates:
            def go(ep, r, cand=cand, seed=5, burn=0):
                return sk._launch(x0, seed + r, burn, ep, side, side,
                                  WEIGHT, 0.0,
                                  sk.make_plan(*cand, burn + ep))
            got = go(7, 0, burn=3)
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            _, per_s = epoch_rate(go, side * side, *points, device=device)
            rows.append([side, *cand, "%.6f" % (per_s * 1e3), equal,
                         tuple(cand) == tuple(chosen)])
            print("\t".join(str(c) for c in rows[-1]), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "lattice_tiles.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
