"""The controls and planted faults that the limits of ``correct`` are set
against: the plain reference put in the program's place, in the nearest
precision below the configuration's float32 (bfloat16), and in learning
the reference with half of the batch left out of the gradient means.
Each configuration's reference module holds its controls
(``control_<phase>``), each giving the numbers the cell's check would
compute; this prints them, one JSON line a seed. The benchmark's own
runs never run these.

    python -m gibbsbench.control --config snorkel_ehr --phase learning \\
        --seeds 11,12,13 [--device cuda] [--epochs N]

``--epochs`` is the number of tallied epochs an inference run's window
gives (the control's marginals are drawn for as many). The tests read
the controls at a smaller size through :func:`readings`' ``graph``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(config: str, phase: str, seed: int, device: str = "cpu",
             epochs: int = 0, graph: dict | None = None) -> dict:
    """The control readings of ``config``'s ``phase`` on the graph of
    ``seed``; ``graph`` overrides keys of the configuration's graph."""
    with open(os.path.join(ROOT, "gibbsbench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    cfg["graph"].update(graph or {})
    gen = importlib.import_module("gibbsbench.generators." +
                                  cfg["generator"])
    data = gen.generate(cfg["graph"], seed)["data"]
    ref = importlib.import_module("gibbsbench.reference." +
                                  cfg["reference"])
    return getattr(ref, "control_" + phase)(cfg, data, seed, device, epochs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--phase", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=0)
    a = ap.parse_args(argv)
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(a.config, a.phase, int(s), a.device, a.epochs)
        print(json.dumps({"config": a.config, "phase": a.phase,
                          "seed": int(s), "epochs": a.epochs,
                          "seconds": time.perf_counter() - t0,
                          "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
