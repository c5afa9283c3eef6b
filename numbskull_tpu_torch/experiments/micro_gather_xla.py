"""Microbenchmark: gather strategies as plain tensor ops on the card.

Port of ``experiments/micro_gather_xla.py``, whose variants are XLA ops
(no Pallas kernel), so torch ops are their port. Each variant gathers
N values ``x[idx]`` from a float32 vector of V values with fixed random
indices, ``iters`` times over (``x = x0 + i`` each time, as the JAX
script defeats common-subexpression elimination), summing into one
(N,) vector:

  plain    x[idx]
  row128   x.view(V/128, 128)[idx >> 7] masked by a one-hot of idx & 127,
           summed over the 128 lanes
  rowtake  the same rows, then gather along the lane axis
  mm128    the rows times the one-hot (bf16 cast to float32), summed
  row8     x.view(V/8, 8)[idx >> 3] masked by a one-hot of idx & 7

``ok``: the variant's sum equals plain's within 1e-3 (the JAX script's
check). ``dt_s``: the median of 3 timed runs of the whole loop after one
warm-up (CUDA events), with the spread; ``elem_per_s`` = N * iters /
dt_s.

Usage: python -m numbskull_tpu_torch.experiments.micro_gather_xla
           [out.tsv] [V] [N] [iters] [--device cuda|cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from numbskull_tpu_torch.benchutil import median_ms
from numbskull_tpu_torch.experiments import common

HEADER = ["variant", "V", "N", "iters", "elem_per_s", "dt_s", "ok",
          "spread_s"]


def variants(idx: torch.Tensor, V: int) -> dict:
    """name -> body(x): the JAX script's gather strategies."""
    r_idx, l_idx = idx >> 7, idx & 127
    lanes = torch.arange(128, device=idx.device)
    loh = l_idx[:, None] == lanes[None, :]
    lohb = loh.to(torch.bfloat16)
    r8, l8 = idx >> 3, idx & 7
    loh8 = l8[:, None] == torch.arange(8, device=idx.device)[None, :]

    def rows(x):
        return x.view(V // 128, 128)[r_idx]

    return {
        "plain": lambda x: x[idx],
        "row128": lambda x: torch.where(loh, rows(x), 0.0).sum(1),
        "rowtake": lambda x: rows(x).gather(1, l_idx[:, None])[:, 0],
        "mm128": lambda x: (rows(x) * lohb.to(torch.float32)).sum(1),
        "row8": lambda x: torch.where(
            loh8, x.view(V // 8, 8)[r8], 0.0).sum(1),
    }


def run(out_path: str = "micro_gather_xla.tsv", V: int = 65536,
        N: int = 262144, iters: int = 100, device="cuda") -> list:
    """Every variant, timed and checked; writes and returns the rows."""
    device = torch.device(device)
    if V % 128:
        raise ValueError("V must be a multiple of 128, not %d" % V)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, V, size=N).astype(np.int64),
                          device=device)
    x0 = torch.as_tensor(rng.standard_normal(V).astype(np.float32),
                         device=device)

    def loop(body):
        acc = torch.zeros(N, dtype=torch.float32, device=device)
        for i in range(iters):
            acc += body(x0 + float(i))
        return acc

    rows, want = [], None
    for name, body in variants(idx, V).items():
        out = loop(body)
        if want is None:
            want = out
        ok = bool(torch.allclose(out, want, atol=1e-3))
        ms, spread = median_ms(lambda: loop(body), device)
        rows.append([name, V, N, iters, "%.4e" % (N * iters / ms * 1e3),
                     "%.6f" % (ms / 1e3), ok, "%.6f" % (spread / 1e3)])
        print("\t".join(str(c) for c in rows[-1]), flush=True)
    common.write_tsv(out_path, HEADER, rows, device)
    return rows


def main(argv=None):
    p = common.parser(__doc__, "micro_gather_xla.tsv")
    p.add_argument("V", nargs="?", type=int, default=65536)
    p.add_argument("N", nargs="?", type=int, default=262144)
    p.add_argument("iters", nargs="?", type=int, default=100)
    args = p.parse_args(argv)
    run(args.out, args.V, args.N, args.iters, args.device)


if __name__ == "__main__":
    main()
