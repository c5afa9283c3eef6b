"""The categorical kernels' time (kmax 3 to 128): ms per inference and
learning epoch, and device time per launch of each color's step, beside
the bound.

Graphs: the data-programming model of ``chip_smoke.py`` phase 13 (d)
(200,000 candidates x 10 LFs, kmax 3), the LF model of phase 5
(200,000 copies x 5 LFs, kmax 3) and Potts 256x256 at cardinality 32 and
128 for inference; the DP model, the LF model (phase 5's L1 setting) and
phase 2's Potts 32x32 at cardinality 64 with 30 % evidence for
learning. For each it builds ``ItemGridEngine``, times epochs
epoch-differenced with CUDA events (``benchutil.epoch_rate``, best of 3
a point), reads each color's kernel launches (in launch order) and
their device time from ``torch.profiler`` over 10 epochs, and computes
the epoch's bound with ``chip_smoke.sweep_epoch_cost`` /
``learn_epoch_cost`` (bytes at 3.35 TB/s, float32 operations at 67
TFLOP/s). Then it prints the registers and local memory a thread of
every categorical kernel that the loaded libraries report.

It calls only long-standing parts of the port (``ItemGridEngine``,
``compile_graph``, the models, ``benchutil``, ``experiments.common``,
``chip_smoke``'s graphs and costs), so that a change can be held against
an earlier checkout in one call on one card: run this file by its path
with ``PYTHONPATH`` at the other checkout's root (its ``chip_smoke`` is
imported too), the two in turns (earlier, change, change, earlier). The
``checkout`` column names the package that was timed; ``--label`` adds
a turn's name to it.

Usage: python -m numbskull_tpu_torch.experiments.cat_rates [out.tsv]
           [--device cuda|cpu] [--label TEXT]
       PYTHONPATH=OTHER python numbskull_tpu_torch/experiments/cat_rates.py
           out.tsv --label 'parent, turn 1'
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numbskull_tpu_torch
from numbskull_tpu_torch.benchutil import epoch_rate
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.models import (ising_color_hint, lf_model,
                                        potts_grid)
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams

HEADER = ["graph", "what", "n_vars", "kmax", "colors", "epoch_ms",
          "bound_ms", "bound_by", "color", "rows", "kernel",
          "launches_per_epoch", "us_per_launch", "checkout"]


def _chip_smoke():
    """``chip_smoke`` of the checkout being timed (PYTHONPATH's root),
    else of the repository that holds this file."""
    try:
        import chip_smoke
    except ImportError:
        sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))))
        import chip_smoke
    return chip_smoke


def configs(scale: float = 1.0) -> list:
    """(name, "infer" or "learn", compiled graph, LearnParams or None)
    of every graph, ``scale`` times its full size."""
    cs = _chip_smoke()

    def cg(t, **kw):
        w, v, f, fm = t[:4]
        return compile_graph(w, v, f, fm, domain_mask=t[4] if len(t) > 4
                             else None, **kw)

    cand = max(int(cs.DP_CANDIDATES * scale), 4)
    copies = max(int(200_000 * scale), 4)
    side = max(int(256 * scale ** 0.5), 4)
    dp = cg(cs.dp_graph(cand, cs.DP_LFS, 5))
    lf = cg(lf_model(0.7, [0.5, 0.25, 0.75, 0.5, 1.0], copies=copies,
                     seed=3))
    r, c = np.divmod(np.arange(32 * 32), 32)
    potts64 = cg(cs._with_evidence(potts_grid(32, 32, card=64, weight=0.0,
                                              fixed=False), 0.3, 64,
                                   ((r // 4) * 3 + c // 4) % 64),
                 color_hint=ising_color_hint(32, 32))
    l1 = LearnParams(regularization=1, reg_param=0.01, truncation=10,
                     learn_non_evidence=True)
    out = [("dp%d" % cand, "infer", dp, None),
           ("lf%d" % copies, "infer", lf, None)]
    for card in (32, 128):
        out.append(("potts%d_card%d" % (side, card), "infer",
                    cg(potts_grid(side, side, card=card, weight=0.25),
                       color_hint=ising_color_hint(side, side)), None))
    out += [("dp%d" % cand, "learn", dp, LearnParams()),
            ("lf%d" % copies, "learn", lf, l1),
            ("potts32_card64_ev30", "learn", potts64,
             LearnParams(regularization=2, reg_param=1e-4))]
    return out


def _runner(eng, lp):
    if lp is None:
        return lambda ep, r: eng.run(1 + r, 0, ep)
    return lambda ep, r: eng.learn(1 + r, 0, ep, 0.1, 0.99, lp)


def color_rows(eng, lp, epochs: int, device) -> list:
    """(color, rows, kernel, launches per epoch, us per launch) of every
    itemgrid kernel in a trace of ``epochs`` epochs: a kernel launched
    once a step with rows and epoch gives its launches to the steps in
    launch order, any other (or a trace that dropped launches) one row
    for all colors."""
    if device.type != "cuda":
        return [("-", "-", "-", "-", "-")]
    t = eng.tables
    steps = [ci for ci in range(t.n_steps) if t.n_rows[ci] > 0]
    common.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _runner(eng, lp)(epochs, 0)
        common.sync(device)
    by = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and
                     e.self_device_time_total > 0),
                    key=lambda e: e.time_range.start):
        if "sweep" in e.name or "learn" in e.name:
            by.setdefault(e.name, []).append(e.self_device_time_total)
    out = []
    for name, us in sorted(by.items()):
        n = len(steps)
        if len(us) == epochs * n:
            for i, ci in enumerate(steps):
                mine = us[i::n]
                out.append((ci, t.n_rows[ci], name[:60],
                            "%.2f" % (len(mine) / epochs),
                            "%.3f" % (sum(mine) / len(mine))))
        else:
            out.append(("all", sum(t.n_rows), name[:60],
                        "%.2f" % (len(us) / epochs),
                        "%.3f" % (sum(us) / len(us))))
    return out or [("-", "-", "-", "-", "-")]


def attrs() -> list:
    """(kernel, registers, local bytes) of the categorical kernels of
    the loaded sweep and learn libraries, where the library reports them
    (an earlier checkout's learn library has no query: its ptxas lines
    instead)."""
    from numbskull_tpu_torch.ops import _build
    out = []
    lib = pig._kernel_lib()
    for which in (12, 13, 14):
        regs, local = ctypes.c_int(), ctypes.c_int()
        if lib.nsx_itemgrid_sweep_attrs(which, ctypes.byref(regs),
                                        ctypes.byref(local)) == 0:
            out.append(("sweep attrs %d" % which, regs.value, local.value))
    llib = pig._kernel_lib("itemgrid_learn")
    fn = getattr(llib, "nsx_learn_attrs", None)
    if fn is not None:
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int,
                                                 ctypes.c_void_p,
                                                 ctypes.c_void_p]
        for which in range(10):   # an earlier library has 7
            regs, local = ctypes.c_int(), ctypes.c_int()
            if fn(which, ctypes.byref(regs), ctypes.byref(local)) == 0:
                out.append(("learn attrs %d" % which, regs.value,
                            local.value))
    info = _build.BUILD_INFO.get("itemgrid_learn")
    if info:
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                out.append(("learn ptxas", line.strip(), ""))
    return out


def run(out_path: str = "cat_rates.tsv", device="cuda", scale: float = 1.0,
        points=(5, 25), label: str = "") -> list:
    """Every graph; writes and returns the rows."""
    device = torch.device(device)
    cs = _chip_smoke()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        numbskull_tpu_torch.__file__)))
    if label:
        checkout = "%s (%s)" % (checkout, label)
    rows = []
    for name, what, cg, lp in configs(scale):
        eng = pig.ItemGridEngine(cg, device=device)
        _, per_s = epoch_rate(_runner(eng, lp), cg.n_vars, *points,
                              device=device)
        cost = (cs.sweep_epoch_cost(torch, eng.tables) if lp is None else
                cs.learn_epoch_cost(torch, eng.learn_tables()))
        b_ms, b_by = common.bound_ms(*cost)
        for color, n, kernel, launches, us in color_rows(eng, lp, 10,
                                                         device):
            rows.append([name, what, cg.n_vars, cg.kmax, cg.n_colors,
                         "%.5f" % (per_s * 1e3), "%.6g" % b_ms, b_by,
                         color, n, kernel, launches, us, checkout])
            print("\t".join(str(c) for c in rows[-1]), flush=True)
        del eng
    if device.type == "cuda":
        for kernel, regs, local in attrs():
            print("# %s: %s registers, %s B local" % (kernel, regs, local),
                  flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "cat_rates.tsv")
    p.add_argument("--label", default="", help="the turn's name, added "
                   "to the checkout column")
    args = p.parse_args(argv)
    run(args.out, args.device, label=args.label)


if __name__ == "__main__":
    main()
