"""The port's CLI against the JAX package's, on the CPU.

The two packages draw from different streams (the JAX package seeds its
kernel from jax.random, the port from numpy's SeedSequence), so their
marginals agree statistically: within 0.05, the Monte-Carlo error of
2000 epochs. Rows, values and the weights file agree exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from numbskull_tpu import numbskull as jax_cli
from numbskull_tpu_torch import dataloading as port_dl
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.models import (coin_exact_marginal, coin_model,
                                       ising_grid)
from test_torch_host import coin_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ising_dir(path):
    w, v, f, fm, _, _ = ising_grid(8, 8, weight=0.1)
    port_dl.write_factor_graph_files(path, w, v, f, fm)
    return path


def _read(path):
    rows = np.loadtxt(path, ndmin=2)
    return rows[:, :-1].astype(np.int64), rows[:, -1]


@pytest.mark.parametrize("graph", ["coin", "ising8x8"])
def test_cli_matches_jax_package(tmp_path, graph):
    src = str(tmp_path / "graph")
    coin_fixture(src) if graph == "coin" else _ising_dir(src)
    args = [src, "-i", "2000", "-b", "100", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    ns = port_cli.main(args + ["-o", out_p, "--device", "cpu"])
    jax_cli.main(args + ["-o", out_j])
    assert ns.factorGraphs[0].device == torch.device("cpu")

    ids_p, prob_p = _read(os.path.join(out_p, "inference_result.out.text"))
    ids_j, prob_j = _read(os.path.join(out_j, "inference_result.out.text"))
    np.testing.assert_array_equal(ids_p, ids_j)
    assert np.abs(prob_p - prob_j).max() <= 0.05
    wname = "inference_result.out.weights.text"
    with open(os.path.join(out_p, wname), "rb") as a, \
            open(os.path.join(out_j, wname), "rb") as b:
        assert a.read() == b.read()


def test_library_api_coin_marginals():
    """NumbSkull.loadFactorGraph + inference on the CPU: marginals of the
    coin model within 0.02 of the exact joint."""
    a, b, c = 0.3, -0.2, 0.4
    ns = port_cli.NumbSkull(n_inference_epoch=3000, burn_in=100,
                            quiet=True, device="cpu")
    ns.loadFactorGraph(*coin_model(16, evidence=False, weight_init=(a, b, c),
                                   fixed=True))
    ns.inference(out=False)
    fg = ns.getFactorGraph()
    marg = fg.full_marginals()
    exact = coin_exact_marginal(a, b, c)
    assert abs(marg[0::2, 1].mean() - (exact[2] + exact[3])) < 0.02
    assert abs(marg[1::2, 1].mean() - (exact[1] + exact[3])) < 0.02
    np.testing.assert_array_equal(fg.getMarginals(), marg[:, 1])
    np.testing.assert_array_equal(fg.getWeights(),
                                  np.float32([a, b, c]))


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    src = coin_fixture(str(tmp_path / "coin"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_cli.main([src, "-i", "10", "-q", "-o", str(tmp_path / "o"),
                       "--device", "cuda"])


@pytest.mark.parametrize("flags", [
    ["-l", "5"], ["--checkpoint", "ck.npz"], ["--parts", "2"],
    ["-u", "sqlite:///g.db"], ["--engine", "xla"], ["--engine", "hbm"]])
def test_cli_unported_flags_raise(tmp_path, flags):
    src = coin_fixture(str(tmp_path / "coin"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_cli.main([src, "-i", "10", "-q", "-o", str(tmp_path / "o"),
                       "--device", "cpu"] + flags)


def test_port_imports_no_jax():
    """In a fresh interpreter: the test process has imported jax."""
    code = ("import sys\n"
            "import numbskull_tpu_torch.numbskull\n"
            "import numbskull_tpu_torch.ops.itemgrid\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'numbskull_tpu' or "
            "m.startswith('numbskull_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
