"""One process of the 2-process gloo check in tests/test_torch_mc.py.

Spawned by ``numbskull_tpu_torch.parallel.multihost.spawn``; imports the
port and torch only (no jax), runs the sharded engine over the group on
the CPU, and saves what it computed for the parent to compare."""

import os

import torch

from _torch_threads import cap_threads

cap_threads()


def run_shard(rank, group, cg, run_args, learn_args, lp, out_dir):
    from numbskull_tpu_torch.ops.itemgrid_mc import MultiChipItemGridEngine
    eng = MultiChipItemGridEngine(cg, group=group, device="cpu")
    x, counts = eng.run(*run_args)
    w, xl, xel = eng.learn(*learn_args, lp=lp)
    torch.save({"x": x, "counts": counts, "w": w, "xl": xl, "xel": xel,
                "shards": eng.shards, "n_g": eng.n_g},
               os.path.join(out_dir, "rank%d.pt" % rank))
