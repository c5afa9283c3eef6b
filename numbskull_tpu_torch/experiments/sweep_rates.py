"""The sweep kernel's time by graph family: ms per inference epoch and
device time per launch (one launch per color).

For each graph (the 1024x1024 Ising of the CLI's main path, the coin and
labeling-function graphs at 200,000 copies, Potts 256x256 at cardinality
32 and 128, grouped voting at degree 10 and 50) it builds
``ItemGridEngine``, times inference epochs epoch-differenced with CUDA
events (``benchutil.epoch_rate``, best of 3 a point) and reads each
sweep kernel's device time per launch over 20 epochs from
``torch.profiler``. It calls only what the port has had since its
experiment drivers came (``ItemGridEngine``, ``compile_graph``, the
models, ``benchutil``, ``experiments.common``), so that a change can be
held against an earlier checkout in one call on one card: run this file
by its path with ``PYTHONPATH`` at the other checkout's root, and the
two in turns (earlier, change, change, earlier). The ``checkout``
column names the package that was timed.

On the CPU the epochs run the plain versions and no kernel is traced.

Usage: python -m numbskull_tpu_torch.experiments.sweep_rates [out.tsv]
           [--device cuda|cpu]
       PYTHONPATH=OTHER python numbskull_tpu_torch/experiments/sweep_rates.py
           out.tsv
"""

from __future__ import annotations

import os

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numbskull_tpu_torch
from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import (coin_model, ising_color_hint,
                                        ising_grid, lf_model, potts_grid,
                                        voting_grouped)
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine

HEADER = ["graph", "n_vars", "colors", "kmax", "epoch_ms", "kernel",
          "launches_per_epoch", "us_per_launch", "checkout"]


def configs(scale: float = 1.0) -> list:
    """(name, model, color hint) of every graph, ``scale`` times its
    full size (at least a few variables)."""
    def n(full, least=8):
        return max(int(full * scale), least)

    side = max(int(1024 * scale ** 0.5), 4)
    pside = max(int(256 * scale ** 0.5), 4)
    return [
        ("ising%d" % side, ising_grid(side, side, weight=0.25),
         ising_color_hint(side, side)),
        ("coin%d" % (2 * n(200_000)),
         coin_model(n(200_000), 0.8, -0.5, 0.4, evidence=True, seed=3),
         None),
        ("lf%d" % n(200_000), lf_model(0.7, [0.5, 0.25, 0.75, 0.5, 1.0],
                                       copies=n(200_000), seed=3), None),
        ("potts%d_card32" % pside, potts_grid(pside, pside, card=32,
                                              weight=0.25),
         ising_color_hint(pside, pside)),
        ("potts%d_card128" % pside, potts_grid(pside, pside, card=128,
                                               weight=0.25),
         ising_color_hint(pside, pside)),
        ("voting_deg10", voting_grouped(n(220_000, 22), 10, weight=0.3),
         None),
        ("voting_deg50", voting_grouped(n(204_000, 102), 50, weight=0.3),
         None),
    ]


def kernel_rows(eng, epochs: int, device) -> list:
    """(kernel, launches per epoch, us per launch) of every kernel in a
    trace of ``epochs`` inference epochs."""
    if device.type != "cuda":
        return [("-", "-", "-")]
    common.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(1, 0, epochs)
        common.sync(device)
    out = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and us > 0 and "kernel" in \
                e.key and "sweep" in e.key:
            out.append((e.key[:80], "%.2f" % (e.count / epochs),
                        "%.3f" % (us / e.count)))
    return out or [("-", "-", "-")]


def run(out_path: str = "sweep_rates.tsv", device="cuda",
        scale: float = 1.0, points=(10, 60)) -> list:
    """Every graph; writes and returns the rows."""
    device = torch.device(device)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        numbskull_tpu_torch.__file__)))
    rows = []
    for name, model, hint in configs(scale):
        w, v, f, fm, dm, _ = model
        cg = compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint)
        eng = ItemGridEngine(cg, device=device)
        _, per_s = epoch_rate(lambda ep, r: eng.run(1 + r, 0, ep), len(v),
                              *points, device=device)
        for kernel, launches, us in kernel_rows(eng, 20, device):
            rows.append([name, len(v), cg.n_colors, cg.kmax,
                         "%.5f" % (per_s * 1e3), kernel, launches, us,
                         checkout])
            print("\t".join(str(c) for c in rows[-1]), flush=True)
        del eng
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "sweep_rates.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
