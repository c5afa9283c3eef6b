"""On a card: one short run of each cell through the command, its last
line correct. Skips where no CUDA device is visible (decided inside the
test); on the card: python -m pytest gibbsbench/tests -k chip."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_chip_cell_runs_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "gibbsbench.run",
                        "--workload", cell, "--seed", str(2 ** 32 + 3),
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
