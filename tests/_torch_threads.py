"""Caps torch's intra-op threads in a pytest-xdist worker.

Every worker would otherwise start one OpenMP thread per core, so six
workers on eight cores run some fifty busy threads, and a test of the
port takes tens of times its serial time. ``cap_threads`` gives each
worker its share of the cores (at least one) and sets
``OMP_NUM_THREADS`` to it, which the processes the tests start
(``multihost.spawn``, ``subprocess``) inherit. Outside xdist it does
nothing. Every ``tests/test_torch_*.py`` and the workers they spawn
call it once, when imported."""

import os

import torch


def cap_threads() -> int | None:
    """Cap torch's threads to this worker's share of the cores; returns
    the cap, or None outside an xdist worker."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 0:
        return None
    cap = max(1, len(os.sched_getaffinity(0)) // workers)
    os.environ["OMP_NUM_THREADS"] = str(cap)
    torch.set_num_threads(cap)
    return cap
