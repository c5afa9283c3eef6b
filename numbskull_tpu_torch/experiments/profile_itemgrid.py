"""Where the itemgrid engine's epoch goes, by kernel.

Port of ``experiments/profile_itemgrid.py``. The TPU driver split an
epoch by ablating kernel stages (a trace-time switch of the Pallas
kernel); the CUDA kernels have no such switch, so this driver reads the
split from ``torch.profiler`` instead. For each configuration (Ising
n x n, grouped voting at degree 10 and 50) it profiles ``epochs``
inference epochs of ``ItemGridEngine.run`` and ``epochs // 10`` learning
epochs of ``.learn`` after one warm-up epoch of each, and writes per
kernel name its calls and device time per epoch (the sweep; the learn
step and sum), then one ``all`` row with the epoch's wall
time (host clock, ended by a synchronize), the device's busy share of
it, and the median host gap between one kernel's end and the next one's
start. The graphs carry a learnable weight and 30 % evidence, so that
learning has gradients to take (inference resamples evidence too).

On the CPU the rows are the operators' self CPU time (the plain
versions run there; no number is a card's).

Usage: python -m numbskull_tpu_torch.experiments.profile_itemgrid
           [out.tsv] [grid_n] [epochs] [--device cuda|cpu]
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import ising_grid, voting_grouped
from numbskull_tpu_torch.ops.itemgrid import ItemGridEngine

HEADER = ["config", "phase", "n_vars", "kernel", "calls_per_epoch",
          "device_ms_per_epoch", "us_per_call", "epoch_ms", "busy_share",
          "median_gap_us"]


def learnable(model, frac: float = 0.3, seed: int = 0):
    """``model`` with its weights learnable and ``frac`` of its variables
    evidence (values as drawn)."""
    w, v, f, fm, dm, e = model
    w["isFixed"] = False
    v["isEvidence"] = (np.random.default_rng(seed).random(len(v)) <
                       frac).astype(np.int8)
    return w, v, f, fm, dm, e


def _counted(e, cuda: bool) -> bool:
    """Whether a trace event is device work: a kernel or copy on a CUDA
    device, an operator on the CPU."""
    if cuda:
        return e.device_type == DeviceType.CUDA
    return e.key.startswith("aten::") if hasattr(e, "key") else \
        e.name.startswith("aten::")


def profile_rows(name: str, phase: str, n_vars: int, fn, epochs: int,
                 device) -> list:
    """Rows of one profiled window of ``fn()`` (``epochs`` epochs)."""
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    common.sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        common.sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6

    def self_us(e):
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    rows, busy = [], 0.0
    for e in sorted(prof.key_averages(), key=lambda e: -self_us(e)):
        us = self_us(e)
        if us <= 0 or not _counted(e, cuda):
            continue
        busy += us
        rows.append([name, phase, n_vars, e.key[:80],
                     "%.2f" % (e.count / epochs),
                     "%.5f" % (us / 1e3 / epochs), "%.3f" % (us / e.count),
                     "-", "-", "-"])
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _counted(e, cuda))
    gaps = [max(b[0] - a[1], 0.0) for a, b in zip(spans, spans[1:])]
    rows.append([name, phase, n_vars, "all", "-", "%.5f" % (
        busy / 1e3 / epochs), "-", "%.5f" % (wall_us / 1e3 / epochs),
        "%.4f" % (busy / wall_us),
        "%.3f" % statistics.median(gaps) if gaps else "-"])
    return rows


def configs(n: int, scale: float = 1.0) -> list:
    s = max(int(200_000 * scale), 60)
    return [("ising%d" % n, ising_grid(n, n, weight=0.3)),
            ("voting_deg10", voting_grouped(s, 10, weight=0.3)),
            ("voting_deg50", voting_grouped(int(s * 1.02), 50,
                                            weight=0.3))]


def run(out_path: str = "profile_itemgrid.tsv", n: int = 1024,
        epochs: int = 300, device="cuda", scale: float = 1.0) -> list:
    """Every configuration; writes and returns the rows."""
    device = torch.device(device)
    rows = []
    learn_epochs = max(epochs // 10, 2)
    for name, model in configs(n, scale):
        w, v, f, fm, dm, _ = learnable(model)
        eng = ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                             device=device)
        eng.run(0, 0, 1)
        eng.learn(0, 0, 1, 0.01)
        rows += profile_rows(name, "infer", len(v),
                             lambda: eng.run(1, 0, epochs), epochs, device)
        rows += profile_rows(name, "learn", len(v),
                             lambda: eng.learn(1, 0, learn_epochs, 0.01),
                             learn_epochs, device)
        del eng
    for row in rows:
        print("\t".join(str(c) for c in row), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "profile_itemgrid.tsv")
    p.add_argument("grid_n", nargs="?", type=int, default=1024)
    p.add_argument("epochs", nargs="?", type=int, default=300)
    args = p.parse_args(argv)
    run(args.out, args.grid_n, args.epochs, args.device)


if __name__ == "__main__":
    main()
