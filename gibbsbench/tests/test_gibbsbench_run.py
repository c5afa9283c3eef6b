"""A run's last line has the contract's keys, the checks last; without a
card the harness exits without a result."""

import json
import os
import subprocess
import sys

import pytest

from gibbsbench.tests.helpers import run_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    res = run_tiny("ehr.infer", trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res) <= {"correct", "attempted", "failed", "metrics",
                        "device", "setup_parts", "breakdown", "checks"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: only the launch counter is read
        assert set(res["metrics"]) == {"sweep.launches_per_epoch"}
    else:
        assert set(res["metrics"]) == {"setup_s", "infer_updates_per_s"}
        for m in res["metrics"].values():
            assert m["value"] > 0
    json.dumps(res, allow_nan=False)


def test_no_card_no_result():
    """Without a CUDA device the command exits 2 and prints nothing to
    standard output (skipped where a card is visible)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = subprocess.run([sys.executable, "-m", "gibbsbench.run",
                        "--workload", "ehr.infer", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr
