"""Microbenchmark of the gather that the itemgrid sweep depends on.

Port of ``experiments/micro_gather.py`` (TPU kernel #10). The TPU
script times, inside a Pallas kernel that loops ``iters`` times over
``ng`` gathers of 1024 values from a (trw, 128) window, ways to build a
gather on a chip that has none (its modes). Every mode computes one of
two functions (``ops/gather``: ``gather_sum``, ``shifted_sum``), so for
every TPU mode name this driver runs the GPU form that computes it, on
the script's own data (numpy, seed 0, drawn in the script's order), and
checks it against the script's numpy formula and the plain version, bit
for bit (``ok``). First a validation pass at trw=16, iters=2, ng=4, then
the script's timing shapes (median of 3 calls, CUDA events).

Then the sweep kernel's sizes, at iters=1: R = 1,048,576 outputs of
ng = 59 gathers each (247.5 MB of offsets, the bytes of one Ising-1M
sweep epoch), from (A) an x of 1,048,576 floats (4 MB, L2-resident like
the sweep's values) and (B) one of 67,108,864 (256 MB, beyond the 50 MB
L2): the kernel's, the plain version's and ``embedding_bag``'s times and
the bound. The bound counts the offsets, the distinct x values gathered
and the output once each; ``sector_bound_ms`` (B only) charges every
random gather the 32-byte sector it fetches from device memory;
``noreuse_ms`` (``micro_gather2``'s span-8 row only) reads every (g, j)
window once from device memory: the time of a kernel that reuses no
window through the L2, a reference and not a bound (sorted shifts read
the windows' overlaps from the L2 and run under it).

Columns: the TPU script's ``mode gpu_form trw ng iters ok ms
Gvals_per_s``, then ``R x_bytes x_in spread_ms plain_ms library_ms
bound_ms bound_by bound_share sector_bound_ms noreuse_ms
max_abs_err`` ('-' where one does not apply; ``x_in``: where the kernel
reads x, shared memory or global, as ``ops/gather.gather_plan`` stages
it; ``max_abs_err``: the kernel against the plain version and the
library call).

Usage: python -m numbskull_tpu_torch.experiments.micro_gather [out.tsv]
           [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from numbskull_tpu_torch.benchutil import median_ms
from numbskull_tpu_torch.experiments import common
from numbskull_tpu_torch.ops import gather as G

RB = 1024
MODES = ("f32_row", "bf16_row", "bf16_lane", "bf16_lane_unr", "roll",
         "roll_unr", "bf16_batch")
VALIDATE = ((16, 2, 4),)                       # (trw, iters, ng)
TIMING = tuple((m, 16, 2000, 16) for m in MODES) + \
    tuple((m, 16, 1000, 52) for m in MODES) + \
    tuple((m, trw, it, 16) for m in ("bf16_lane_unr", "bf16_batch")
          for trw, it in ((8, 2000), (128, 200)))
SWEEP_R, SWEEP_NG = 1 << 20, 59
SWEEP_X = (("sweep_A", 1 << 20), ("sweep_B", 1 << 26))
HEADER = ["mode", "gpu_form", "trw", "ng", "iters", "ok", "ms",
          "Gvals_per_s", "R", "x_bytes", "x_in", "spread_ms", "plain_ms",
          "library_ms", "bound_ms", "bound_by", "bound_share",
          "sector_bound_ms", "noreuse_ms", "max_abs_err"]


def tpu_data(trw: int, ng: int, pad: int, seed: int = 0) -> tuple:
    """The TPU script's x ((trw + pad, 128) float32 0/1), off ((ng, 1024)
    int32 below trw * 128) and shift: the same numpy draws, in its
    order (micro_gather.py:120-124, micro_gather2.py:96-100)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, size=(trw + pad, 128)).astype(np.float32)
    off = rng.integers(0, trw * 128, size=(ng, RB)).astype(np.int32)
    shift = rng.integers(0, max(trw - pad, 1) * 128,
                         size=(max(ng, 8),)).astype(np.int32)
    return x, off, shift


def numpy_want(mode: str, x, off, shift, trw: int, ng: int,
               iters: int) -> np.ndarray:
    """The TPU script's own numpy formula for ``mode``."""
    form, span = G.TPU_MODES[mode]
    if form == "shifted_sum":
        flat = x.reshape(-1)
        want = np.zeros(RB * span)
        for g in range(ng):
            c = int(shift[g])
            want += flat[c:c + RB * span]
        want = want.reshape(span, RB).sum(0)
    else:
        want = x[:trw].reshape(-1)[off].sum(0)
    return want * iters


def form_label(form: str, span: int) -> str:
    return form if form == "gather_sum" else "%s span %d" % (form, span)


def x_in(form: str, R: int, ng: int, span: int, iters: int, nx: int,
         device) -> str:
    """Where the kernel reads x on the card: "shared" where the plan
    stages the window, else "global"; "-" off the card."""
    if torch.device(device).type != "cuda":
        return "-"
    staged = G.gather_plan(form, R, ng, span, iters, nx).staged
    return "shared" if staged else "global"


def run_mode(mode: str, trw: int, iters: int, ng: int, pad: int,
             device, timed: bool = True) -> list:
    """One TSV row: the GPU form of ``mode`` on the TPU script's data,
    checked against its numpy formula and the plain version."""
    form, span = G.TPU_MODES[mode]
    x, off, shift = tpu_data(trw, ng, pad)
    xt = torch.as_tensor(x, device=device)
    if form == "gather_sum":
        offt = torch.as_tensor(off, device=device)

        def fn(validate=True):
            return G.gather_sum(xt, offt, iters, validate=validate)
        plain = G.gather_sum_reference(xt, offt, iters)
    else:
        sh = torch.as_tensor(shift[:ng], device=device)

        def fn(validate=True):
            return G.shifted_sum(xt, sh, RB, span, iters, validate=validate)
        plain = G.shifted_sum_reference(xt, sh, RB, span, iters)
    out = fn()
    want = numpy_want(mode, x, off, shift, trw, ng, iters)
    ok = bool(np.array_equal(out.cpu().numpy(), want) and
              torch.equal(out, plain))
    err = float((out - plain).abs().max())
    ms = spread = "-"
    gvals = "-"
    if timed:
        ms, spread = median_ms(lambda: fn(False), device)
        gvals = "%.4g" % (RB * ng * span * iters / ms / 1e6)
        ms, spread = "%.5f" % ms, "%.5f" % spread
    return [mode, form_label(form, span), trw, ng, iters, ok, ms, gvals, RB,
            x.nbytes, x_in(form, RB, ng, span, iters, x.size, device),
            spread, "-", "-", "-", "-", "-", "-", "-", err]


def timed_row(name: str, form: str, span: int, x, iters: int, R: int,
              ng: int, kernel, plain, library, nbytes: int,
              sector_bytes, device, noreuse_bytes=None) -> list:
    """One TSV row at a size of the sweep kernel: kernel, plain version
    and library call equal bit for bit, their median times, the bound
    (``nbytes`` and one add per gather) and, when given, the sector
    bound and the no-reuse time."""
    out = kernel(True)
    ref, lib = plain(), library()
    ok = bool(torch.equal(out, ref) and torch.equal(out, lib))
    err = max(float((out - ref).abs().max()), float((out - lib).abs().max()))
    del ref, lib
    ms, spread = median_ms(lambda: kernel(False), device)
    plain_ms, _ = median_ms(plain, device)
    lib_ms, _ = median_ms(library, device)
    bnd, by = common.bound_ms(nbytes, R * ng * span * iters)
    sector, noreuse = ("-" if b is None else
                       "%.5f" % (b / common.H100_BYTES_PER_S * 1e3)
                       for b in (sector_bytes, noreuse_bytes))
    return [name, form_label(form, span), "-", ng, iters, ok, "%.5f" % ms,
            "%.4g" % (R * ng * span * iters / ms / 1e6), R, x.numel() * 4,
            x_in(form, R, ng, span, iters, x.numel(), device),
            "%.5f" % spread, "%.5f" % plain_ms, "%.5f" % lib_ms,
            "%.5f" % bnd, by, "%.4f" % (bnd / ms), sector, noreuse, err]


def random_window(nx: int, device, gen) -> torch.Tensor:
    """nx float32 0/1 values drawn on ``device``."""
    return torch.randint(0, 2, (nx,), generator=gen, device=device,
                         dtype=torch.float32)


def sweep_gather_row(name: str, nx: int, R: int, ng: int, device,
                     seed: int = 1) -> list:
    """gather_sum at iters=1 over R outputs of ng random gathers each
    from an x of nx floats, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = random_window(nx, device, gen)
    off = torch.randint(0, nx, (ng, R), generator=gen, device=device,
                        dtype=torch.int32)
    off_t = off.t().contiguous()
    distinct = int(torch.unique(off).numel())
    nbytes = 4 * off.numel() + 4 * distinct + 4 * R
    sector = 4 * off.numel() + 4 * R + 32 * off.numel() \
        if 4 * nx > common.H100_L2_BYTES else None
    return timed_row(
        name, "gather_sum", 1, x, 1, R, ng,
        lambda validate: G.gather_sum(x, off, 1, validate=validate),
        lambda: G.gather_sum_reference(x, off, 1),
        lambda: G.library_gather_sum(x, off_t, 1), nbytes, sector, device)


def run(out_path: str = "micro_gather.tsv", device="cuda",
        validate=VALIDATE, timing=TIMING, sweep_r: int = SWEEP_R,
        sweep_ng: int = SWEEP_NG, sweep_x=SWEEP_X) -> list:
    """The TPU script's schedule, then the sweep sizes; writes and
    returns the rows."""
    device = torch.device(device)
    rows = [run_mode(m, trw, it, ng, 8, device, timed=False)
            for trw, it, ng in validate for m in MODES]
    rows += [run_mode(m, trw, it, ng, 8, device)
             for m, trw, it, ng in timing]
    rows += [sweep_gather_row(name, nx, sweep_r, sweep_ng, device)
             for name, nx in sweep_x]
    for row in rows:
        print("\t".join(str(c) for c in row), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    args = common.parser(__doc__, "micro_gather.tsv").parse_args(argv)
    run(args.out, args.device)


if __name__ == "__main__":
    main()
