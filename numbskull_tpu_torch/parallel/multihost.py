"""Multi-process execution over ``torch.distributed``.

Port of ``numbskull_tpu/parallel/multihost.py:32-58``: where the JAX
package initializes ``jax.distributed`` and builds a global mesh, the
port joins a ``torch.distributed`` process group, which
``MultiChipItemGridEngine(cg, group=...)`` shards a graph over (one
shard per process). Nothing here reads a cluster's environment unless
the caller leaves ``init_method`` to ``env://``.

Typical use (the same program in every process):

    from numbskull_tpu_torch.parallel import multihost
    group = multihost.initialize("nccl", "tcp://host:29500", rank, size)
    eng = MultiChipItemGridEngine(cg, group=group)
    x, counts = eng.run(seed, burn, epochs)
    if multihost.is_coordinator():
        ...write the outputs...

``spawn`` runs a function in fresh processes on this host, joined by a
group over a file store in a temporary directory.
"""

from __future__ import annotations

import os
import tempfile

import torch.distributed as dist


def initialize(backend: str = "gloo", init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None):
    """Join the default process group (once) and return it. ``nccl``
    needs one GPU per process; ``gloo`` runs anywhere, any number of
    processes on one GPU included. ``init_method`` None means
    ``env://`` (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)."""
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
        dist.init_process_group(backend=backend, init_method=init_method,
                                **kw)
    return dist.group.WORLD


def is_coordinator() -> bool:
    """True on the process that should write outputs (rank 0, or the
    only process when no group was joined)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _entry(rank: int, fn, world_size: int, backend: str, init_file: str,
           args: tuple) -> None:
    group = initialize(backend, "file://" + init_file, rank, world_size)
    try:
        fn(rank, group, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (),
          backend: str = "gloo") -> None:
    """Run ``fn(rank, group, *args)`` in ``world_size`` new processes
    (start method ``spawn``) joined by a ``backend`` group, and wait for
    all of them; a process that fails raises here. ``fn`` must be
    importable by name from the new processes."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="nsx_pg_") as tmp:
        mp.start_processes(_entry, args=(fn, world_size, backend,
                                         os.path.join(tmp, "store"), args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
