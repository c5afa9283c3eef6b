"""The gather kernels' time by shape: ms per call and device time per
launch, for holding one checkout against another.

Rows: ``gather_sum`` at the sweep kernel's sizes (R = 1,048,576 outputs
of 59 random gathers from a 4 MB x, A, and from a 256 MB x, B, with x
of 256 KB, 1 MB, 16 MB and 64 MB between: where the random loads are
served from L1, L2 or device memory), ``shifted_sum`` with span 8 over
a 256 MB window at the same R, its shifts as drawn and rounded down to
a 32-byte sector (``span8_aligned``: a warp's loads then fetch the
sectors that aligned vector loads would), then the TPU scripts' timing
shapes (``micro_gather.TIMING``, ``micro_gather2.TIMING``, R = 1024),
one row per GPU form and shape (the TPU modes that share both compute
the same function on the same data; ``modes`` names them). Each row
gives the median of ``calls`` single calls timed with CUDA events
(``call_ms``, the wrapper's host work included), the kernel's device
time per launch from ``torch.profiler`` over ``calls`` calls
(``device_ms``) and the loads of x it makes a second at that time
(``Gloads_per_s``: one a gather, span a shift), the bound
(``common.bound_ms``:
the offsets or shifts, the distinct x values and the output once each,
one add per gather) and, at B and span 8, what device memory would
serve with no reuse in a cache (``noreuse_ms``: a 32-byte sector per
random gather; every (g, j) window once), a reference and not a bound:
a kernel that reads from the L2 what it read before runs under it.

It calls only what the port has had since its experiment drivers came
(``ops.gather``, ``benchutil``, ``experiments.common``,
``micro_gather.tpu_data`` and the scripts' ``TIMING``), so that a change
can be held against an earlier checkout in one call on one card: run
this file by its path with ``PYTHONPATH`` at the other checkout's root,
and the two in turns (earlier, change, change, earlier). The
``checkout`` column names the package that was timed, or holds
``--label``.

On the CPU the calls run the plain versions and no kernel is traced.

Usage: python -m numbskull_tpu_torch.experiments.gather_rates [out.tsv]
           [--device cuda|cpu] [--label TEXT]
       PYTHONPATH=OTHER python numbskull_tpu_torch/experiments/gather_rates.py
           out.tsv --label 'parent, turn 1'
"""

from __future__ import annotations

import os

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import numbskull_tpu_torch
from numbskull_tpu_torch.benchutil import median_ms
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.experiments import micro_gather as mg
from numbskull_tpu_torch.experiments import micro_gather2 as mg2
from numbskull_tpu_torch.ops import gather as G

HEADER = ["row", "modes", "form", "R", "ng", "span", "iters", "x_bytes",
          "call_ms", "device_ms", "Gloads_per_s", "launches", "bound_ms",
          "noreuse_ms", "checkout"]
# (row, x floats) of gather_sum at the sweep's R and ng: A and B, and
# windows between that the L1, the L2 or device memory serve; the
# span-8 window as micro_gather2's
SIZES = (("x_256KB", 1 << 16), ("x_1MB", 1 << 18), ("sweep_A", 1 << 20),
         ("x_16MB", 1 << 22), ("x_64MB", 1 << 24), ("sweep_B", 1 << 26))
KERNELS = ("gather_sum_kernel", "shifted_sum_kernel")


def tpu_shapes(timing=None, timing2=None) -> list:
    """(modes, form, span, trw, iters, ng, pad) of the TPU scripts' timing
    rows, one per GPU form and shape."""
    rows = {}
    for trw_rows, pad in (
            ([(m, trw, it, ng) for m, trw, it, ng in
              (mg.TIMING if timing is None else timing)], 8),
            ([(m, trw, it, ng) for trw, it, ng in
              (mg2.TIMING if timing2 is None else timing2)
              for m in mg2.MODES], 64)):
        for mode, trw, iters, ng in trw_rows:
            form, span = G.TPU_MODES[mode]
            key = (form, span, trw, iters, ng, pad)
            rows.setdefault(key, []).append(mode)
    return [("+".join(modes),) + key for key, modes in rows.items()]


def device_ms(fn, calls: int, device) -> tuple:
    """(ms per launch, launches) of the gather kernels in a trace of
    ``calls`` calls of ``fn``; ("-", "-") off the card."""
    if device.type != "cuda":
        return "-", "-"
    common.sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        common.sync(device)
    us = n = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                any(k in e.key for k in KERNELS):
            us += e.self_device_time_total
            n += e.count
    return ("%.6f" % (us / n / 1e3), n) if n else ("-", 0)


def timed(row, modes, form, span, R, ng, iters, x, fn, nbytes,
          noreuse_bytes, calls, device, checkout) -> list:
    fn()                                 # warm (and build) first
    ms, _ = median_ms(fn, device, n=calls)
    dev_ms, launches = device_ms(fn, calls, device)
    bound, _ = common.bound_ms(nbytes, R * ng * span * iters)
    noreuse = "-" if noreuse_bytes is None else \
        "%.6f" % (noreuse_bytes / common.H100_BYTES_PER_S * 1e3)
    rate = "-" if dev_ms == "-" else \
        "%.4g" % (R * ng * span * iters / float(dev_ms) / 1e6)
    out = [row, modes, form, R, ng, span, iters, x.numel() * 4, "%.6f" % ms,
           dev_ms, rate, launches, "%.6f" % bound, noreuse, checkout]
    print("\t".join(str(c) for c in out), flush=True)
    return out


def run(out_path: str = "gather_rates.tsv", device="cuda", sizes=SIZES,
        sweep_r: int = mg.SWEEP_R, sweep_ng: int = mg.SWEEP_NG,
        span_nx: int = mg2.SWEEP_NX, timing=None, timing2=None,
        calls: int = 20, label: str | None = None) -> list:
    """Every row; writes and returns them. ``checkout`` holds ``label``,
    or the root of the package timed."""
    device = torch.device(device)
    checkout = label or os.path.dirname(os.path.dirname(os.path.abspath(
        numbskull_tpu_torch.__file__)))
    rows = []
    R, ng = sweep_r, sweep_ng
    for name, nx in sizes:
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randint(0, 2, (nx,), generator=gen, device=device,
                          dtype=torch.float32)
        off = torch.randint(0, nx, (ng, R), generator=gen, device=device,
                            dtype=torch.int32)
        nbytes = 4 * off.numel() + 4 * int(torch.unique(off).numel()) + 4 * R
        sector = 4 * off.numel() + 4 * R + 32 * off.numel() \
            if 4 * nx > common.H100_L2_BYTES else None
        rows.append(timed(name, "-", "gather_sum", 1, R, ng, 1, x,
                          lambda: G.gather_sum(x, off, 1, validate=False),
                          nbytes, sector, calls, device, checkout))
        del x, off
    span = mg2.SPAN
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randint(0, 2, (span_nx,), generator=gen, device=device,
                      dtype=torch.float32)
    shift = torch.randint(0, span_nx - R * span + 1, (ng,), generator=gen,
                          device=device, dtype=torch.int32)
    # and the same shifts rounded down to a 32-byte sector, so that a
    # warp's 32 consecutive floats span 4 sectors and not 5: the sectors
    # a kernel of aligned vector loads would fetch for any shift
    for name, sh in (("sweep_span8", shift),
                     ("span8_aligned", shift - shift % 8)):
        nbytes = 4 * ng + 4 * R + 4 * mg2.covered(sh.tolist(), R * span)
        rows.append(timed(name, "-", "shifted_sum", span, R, ng, 1, x,
                          lambda sh=sh: G.shifted_sum(x, sh, R, span, 1,
                                                      validate=False),
                          nbytes, 4 * ng * span * R + 4 * ng + 4 * R, calls,
                          device, checkout))
    del x, shift, sh
    for modes, form, span, trw, iters, ng, pad in tpu_shapes(timing,
                                                             timing2):
        xn, offn, shiftn = mg.tpu_data(trw, ng, pad)
        x = torch.as_tensor(xn, device=device)
        if form == "gather_sum":
            off = torch.as_tensor(offn, device=device)
            fn = (lambda x=x, off=off, iters=iters:
                  G.gather_sum(x, off, iters, validate=False))
            nbytes = x.numel() * 4 + off.numel() * 4 + 4 * mg.RB
        else:
            sh = torch.as_tensor(shiftn[:ng], device=device)
            fn = (lambda x=x, sh=sh, span=span, iters=iters:
                  G.shifted_sum(x, sh, mg.RB, span, iters, validate=False))
            nbytes = x.numel() * 4 + 4 * ng + 4 * mg.RB
        rows.append(timed("tpu_trw%d" % trw, modes, form, span, mg.RB, ng,
                          iters, x, fn, nbytes, None, calls, device,
                          checkout))
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "gather_rates.tsv")
    p.add_argument("--label", help="the checkout column's text (default: "
                   "the root of the package timed)")
    args = p.parse_args(argv)
    run(args.out, args.device, label=args.label)


if __name__ == "__main__":
    main()
