"""The lattice kernel's time by lattice size: ms per sweep and device time
per launch.

For each side (1024, 2048 and 8192, the lattice cells of ``bench.py``)
it builds ``GridGibbsEngine(side, side, 0.3)``, times ``run`` epoch-
differenced with CUDA events (``benchutil.epoch_rate``, best of 3 a
point; the call's own work, its initial lattice and allocations, drops
out) and reads the lattice kernel's launches and device time per launch,
and the device busy share, over a 50-sweep ``run`` from
``torch.profiler``. It calls only what the port has had since its lattice
engine came (``GridGibbsEngine``, ``benchutil``, ``experiments.common``),
so that a change can be held against an earlier checkout in one call on
one card: run this file by its path with ``PYTHONPATH`` at the other
checkout's root, and the two in turns (earlier, change, change,
earlier). The ``checkout`` column names the package that was timed.

On the CPU the sweeps run the plain version and no kernel is traced.

Usage: python -m numbskull_tpu_torch.experiments.lattice_rates [out.tsv]
           [--device cuda|cpu]
       PYTHONPATH=OTHER python numbskull_tpu_torch/experiments/lattice_rates.py
           out.tsv
"""

from __future__ import annotations

import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numbskull_tpu_torch
from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.ops.stencil import GridGibbsEngine

HEADER = ["side", "cells", "sweep_ms", "kernel", "launches_per_sweep",
          "us_per_launch", "busy_share", "checkout"]
SIDES = (1024, 2048, 8192)
WEIGHT = 0.3                    # bench.py:48, the lattice cells' weight
TRACE_SWEEPS = 50


def kernel_rows(eng, sweeps: int, device) -> list:
    """(kernel, launches per sweep, us per launch, busy share) of each
    lattice kernel in a trace of one ``sweeps``-sweep run; the busy share
    counts every device row of the window."""
    if device.type != "cuda":
        return [("-", "-", "-", "-")]
    common.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(1, 0, sweeps)
        common.sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, busy_us = [], 0.0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        busy_us += us
        if "stencil" in e.key or "lattice" in e.key:
            rows.append([e.key[:80], "%.4f" % (e.count / sweeps),
                         "%.3f" % (us / e.count)])
    share = "%.3f" % (busy_us / wall_us)
    return [r + [share] for r in rows] or [("-", "-", "-", share)]


def run(out_path: str = "lattice_rates.tsv", device="cuda", sides=SIDES,
        points=(16, 200)) -> list:
    """Every side; writes and returns the rows."""
    device = torch.device(device)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        numbskull_tpu_torch.__file__)))
    rows = []
    for side in sides:
        eng = GridGibbsEngine(side, side, WEIGHT, device=device)
        _, per_s = epoch_rate(lambda ep, r: eng.run(1 + r, 0, ep),
                              side * side, *points, device=device)
        for kernel, launches, us, busy in kernel_rows(eng, TRACE_SWEEPS,
                                                      device):
            rows.append([side, side * side, "%.6f" % (per_s * 1e3), kernel,
                         launches, us, busy, checkout])
            print("\t".join(str(c) for c in rows[-1]), flush=True)
        del eng
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "lattice_rates.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
