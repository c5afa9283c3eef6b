"""Workers of tests/test_torch_multihost.py, spawned by
``numbskull_tpu_torch.parallel.multihost.spawn``; they import the port
and torch only (no jax)."""

import os
import time

import torch
import torch.distributed as dist


def run_mesh(rank, group, cg, shape, infer_args, learn_args, lp, out_dir):
    """One (chain, shard) of a ``global_mesh`` on the CPU: inference,
    pooled marginals and learning as the parent runs them in one
    process; what it computed goes to ``out_dir``."""
    from numbskull_tpu_torch.parallel import multihost
    from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine
    mesh = multihost.global_mesh(*shape, device="cpu")
    eng = ShardedGibbsEngine(cg, mesh)
    st = eng.inference(eng.init_state(), *infer_args)
    marg = eng.marginals(st, infer_args[1])
    ls = eng.learn(eng.init_state(), *learn_args, lp=lp)
    torch.save({"chains": mesh.chains, "shards": mesh.shards,
                "state": st, "marg": marg, "learned": ls},
               os.path.join(out_dir, "rank%d.pt" % rank))


def stall(rank, group):
    """Rank 1 never reaches the barrier that rank 0 waits in."""
    if rank == 1:
        time.sleep(3600)
    dist.barrier(group)
