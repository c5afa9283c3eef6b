"""Microbenchmark of the gather, round 2: ``roll64``, ``fact`` and
``take``, and the span-8 shifted gather at the sweep kernel's size.

Port of ``experiments/micro_gather2.py`` (TPU kernel #11), on the
machinery of ``micro_gather``: for each TPU mode name the GPU form that
computes its function (``roll64``: ``shifted_sum`` with span 8, one
shift serving 8192 values; ``fact`` and ``take``: ``gather_sum``) on the
script's own data ((trw + 64, 128) windows), checked against its numpy
formula and the plain version bit for bit, first at trw=16, iters=2,
ng=4, then at its timing shape (trw=16, iters=2000, ng=16). Then
``shifted_sum`` with span 8 at iters=1 over R = 1,048,576 outputs and
ng = 59 shifts of a 256 MB window (67,108,864 floats): the kernel's,
the plain version's and ``embedding_bag``'s times (the library call
gathers through the 472 x R offsets the shifts expand to, made outside
the timed region), the bound, which counts the shifts, the output and
the union of the windows the shifts read once each, and the no-reuse
time, which reads every (g, j) window once from device memory with the
shifts and the output (a reference: the kernel reads the windows'
overlaps from the L2).

Columns as ``micro_gather``'s.

Usage: python -m numbskull_tpu_torch.experiments.micro_gather2 [out.tsv]
           [--device cuda|cpu]
"""

from __future__ import annotations

import torch

from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.experiments.micro_gather import (
    HEADER, random_window, run_mode, timed_row)
from numbskull_tpu_torch.ops import gather as G

MODES = ("roll64", "fact", "take")
VALIDATE = ((16, 2, 4),)                      # (trw, iters, ng)
TIMING = ((16, 2000, 16),)
SPAN = 8
SWEEP_R, SWEEP_NG, SWEEP_NX = 1 << 20, 59, 1 << 26


def covered(starts, length: int) -> int:
    """How many positions the windows [s, s + length) cover together."""
    total, end = 0, -1
    for s in sorted(int(v) for v in starts):
        lo = max(s, end)
        total += max(s + length - lo, 0)
        end = max(end, s + length)
    return total


def sweep_shifted_row(name: str, nx: int, R: int, ng: int, span: int,
                      device, seed: int = 2) -> list:
    """shifted_sum at iters=1 over R outputs and ng shifts of span
    blocks each, from an x of nx floats drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = random_window(nx, device, gen)
    shift = torch.randint(0, nx - R * span + 1, (ng,), generator=gen,
                          device=device, dtype=torch.int32)
    off_t = G.shifted_offsets(shift, R, span).t().contiguous()
    nbytes = 4 * ng + 4 * R + 4 * covered(shift.tolist(), R * span)
    return timed_row(
        name, "shifted_sum", span, x, 1, R, ng,
        lambda validate: G.shifted_sum(x, shift, R, span, 1,
                                       validate=validate),
        lambda: G.shifted_sum_reference(x, shift, R, span, 1),
        lambda: G.library_gather_sum(x, off_t, 1), nbytes, None, device,
        noreuse_bytes=4 * ng * span * R + 4 * ng + 4 * R)


def run(out_path: str = "micro_gather2.tsv", device="cuda",
        validate=VALIDATE, timing=TIMING, sweep_r: int = SWEEP_R,
        sweep_ng: int = SWEEP_NG, sweep_nx: int = SWEEP_NX) -> list:
    """The TPU script's schedule, then the span-8 sweep size; writes and
    returns the rows."""
    device = torch.device(device)
    rows = [run_mode(m, trw, it, ng, 64, device, timed=False)
            for trw, it, ng in validate for m in MODES]
    rows += [run_mode(m, trw, it, ng, 64, device)
             for trw, it, ng in timing for m in MODES]
    rows.append(sweep_shifted_row("sweep_span8", sweep_nx, sweep_r,
                                  sweep_ng, SPAN, device))
    for row in rows:
        print("\t".join(str(c) for c in row), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "micro_gather2.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
