"""Tiny forms of the benchmark's cells for the CPU tests: the same
configuration files, cut to a size a test can hold, run with the
program's plain versions (``device='cpu'``)."""

from __future__ import annotations

import importlib

from gibbsbench import run

TINY_EPOCHS = 5


def tiny(name: str):
    """(bench, cell, cfg, traffic) of workload ``name`` at a tiny size."""
    bench, cell, cfg, traffic = run.load_cell(name)
    gen = importlib.import_module("gibbsbench.generators." +
                                  cfg["generator"])
    cfg["graph"].update(gen.TINY)
    for phase, key in (("learning", "n_learning_epoch"),
                       ("inference", "n_inference_epoch")):
        if phase in cfg:
            cfg[phase][key] = TINY_EPOCHS
    return bench, cell, cfg, traffic


def run_tiny(name: str, seed: int = 2 ** 33 + 7, trace: bool = False,
             seconds: float = 0.0) -> dict:
    bench, cell, cfg, traffic = tiny(name)
    return run.run_cell(bench, cell, cfg, traffic, seed, seconds, trace,
                        "cpu")
