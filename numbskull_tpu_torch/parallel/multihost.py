"""Multi-process execution over ``torch.distributed``.

Port of ``numbskull_tpu/parallel/multihost.py``: where the JAX package
initializes ``jax.distributed`` and builds a global mesh, the port joins
a ``torch.distributed`` process group and lays a (chains, graph) mesh
over it (``global_mesh``, one (chain, shard) per process), which
``ShardedGibbsEngine`` runs on; ``MultiChipItemGridEngine(cg,
group=...)`` shards a graph over the group itself (one shard per
process). Nothing here reads a cluster's environment unless the caller
leaves ``init_method`` to ``env://``.

Typical use (the same program in every process; every process builds
the same CompiledGraph):

    from numbskull_tpu_torch.parallel import multihost
    multihost.initialize("nccl", "tcp://host:29500", rank, size)
    mesh = multihost.global_mesh(n_chains=4)    # chains x graph over
    eng = ShardedGibbsEngine(cg, mesh)          # every process
    st = eng.inference(eng.init_state(), seed, epochs, burn)
    marg = eng.marginals(st, epochs)
    if multihost.is_coordinator():
        ...write the outputs...

``spawn`` runs a function in fresh processes on this host, joined by a
group over a file store in a temporary directory. No wait is unbounded:
a group's collectives raise after its timeout (``mesh.TIMEOUT`` unless
the caller gives another), and ``spawn`` terminates its processes and
raises when they outlast its deadline.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch.distributed as dist

from numbskull_tpu_torch.parallel.mesh import TIMEOUT, Mesh, make_mesh


def initialize(backend: str = "gloo", init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout: datetime.timedelta = TIMEOUT):
    """Join the default process group (once) and return it. ``nccl``
    needs one GPU per process; ``gloo`` runs anywhere, any number of
    processes on one GPU included. ``init_method`` None means
    ``env://`` (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE). The
    rendezvous and every collective of the group raise after
    ``timeout``."""
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
        dist.init_process_group(backend=backend, init_method=init_method,
                                timeout=timeout, **kw)
    return dist.group.WORLD


def global_mesh(n_chains: int = 1, n_graph: int | None = None,
                device="cuda") -> Mesh:
    """(chains, graph) mesh over every process of the default group, on
    ``device`` in this process (``make_mesh`` over ``dist.group.WORLD``;
    every process calls it)."""
    return make_mesh(n_chains, n_graph, group=dist.group.WORLD,
                     device=device)


def is_coordinator() -> bool:
    """True on the process that should write outputs (rank 0, or the
    only process when no group was joined)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _entry(rank: int, fn, world_size: int, backend: str, init_file: str,
           args: tuple, timeout_s: float) -> None:
    group = initialize(backend, "file://" + init_file, rank, world_size,
                       datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, group, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), backend: str = "gloo",
          timeout: float = TIMEOUT.total_seconds()) -> None:
    """Run ``fn(rank, group, *args)`` in ``world_size`` new processes
    (start method ``spawn``) joined by a ``backend`` group, and wait for
    all of them; a process that fails raises here. ``fn`` must be
    importable by name from the new processes. ``timeout`` (seconds) is
    the group's timeout and the deadline of the whole run: past it the
    processes are terminated and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="nsx_pg_") as tmp:
        ctx = mp.start_processes(
            _entry, args=(fn, world_size, backend,
                          os.path.join(tmp, "store"), args, timeout),
            nprocs=world_size, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "spawn: %d processes still running after %.0f s"
                        % (sum(p.is_alive() for p in ctx.processes),
                           timeout))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
