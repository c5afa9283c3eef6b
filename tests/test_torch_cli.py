"""The port's CLI against the JAX package's, on the CPU, and the CLI's
checkpointed runs against themselves.

The two packages draw from different streams (the JAX package seeds its
kernel from jax.random, the port from numpy's SeedSequence), so their
marginals agree statistically: within 0.05, the Monte-Carlo error of
2000 epochs. Rows, values and the weights file agree exactly when
nothing is learned; learned weights agree statistically (the tolerances
are stated at each test).
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
                                       ising_grid, potts_grid)
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


def _publish_coin_db(path):
    """The coin fixture's arrays as sharding tables in a sqlite file."""
    import sqlite3

    from numbskull_tpu_torch import dbsource
    src = coin_fixture(os.path.join(os.path.dirname(path), "coin_src"))
    _, w, v, f, fm, _, _ = port_dl.load_factor_graph_files(
        src, "graph.meta", "graph.weights", "graph.variables",
        "graph.factors", "graph.domains")
    conn = sqlite3.connect(path)
    dbsource.write_graph_to_db(conn.cursor(), "coin", w, v, f, fm)
    conn.commit()
    conn.close()


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "ck.npz"], ["--parts", "2", "-u", "DB"],
    ["-u", "DB"], ["--engine", "xla"],
    ["--engine", "hbm", "--checkpoint", "ck.npz"]])
def test_cli_formerly_unported_flags_run(tmp_path, monkeypatch, flags):
    """The options that raised NotImplementedError before they were
    ported now run on the CPU and write both output files: 18 marginal
    rows of the coin fixture (from files, or with -u from its copy in a
    sqlite file) and its one weight; a checkpoint, where asked for, is
    written."""
    src = coin_fixture(str(tmp_path / "coin"))
    _publish_coin_db(str(tmp_path / "g.db"))
    flags = ["sqlite://" + str(tmp_path / "g.db") if f == "DB" else f
             for f in flags]
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "o")
    port_cli.main([src, "-l", "2", "-i", "10", "-q", "-o", out,
                   "--device", "cpu"] + flags)
    rows = np.loadtxt(os.path.join(out, "inference_result.out.text"),
                      ndmin=2)
    assert rows.shape == (18, 3)
    assert ((rows[:, 2] >= 0) & (rows[:, 2] <= 1)).all()
    w = np.loadtxt(os.path.join(out, "inference_result.out.weights.text"),
                   ndmin=2)
    assert w.shape == (1, 2)
    if "--checkpoint" in flags:
        assert os.path.exists("ck.npz") and os.path.exists("ck.npz.learn")


def _cli_out(src, out, *flags):
    port_cli.main([src, "-o", out, "-q", "--seed", "5", "--device", "cpu"] +
                  list(flags))
    return [open(os.path.join(out, name), "rb").read() for name in
            ("inference_result.out.text",
             "inference_result.out.weights.text")]


@pytest.mark.parametrize("engine", ["xla", "auto"])
def test_cli_checkpoint_resume(tmp_path, engine):
    """--checkpoint (tests/test_cli.py:44-66 on the coin fixture): a run
    interrupted after 80 epochs (2 chunks of 40) and resumed to 120
    writes the uninterrupted chunked run's marginals, byte for byte, and
    counts one resume. Under --engine xla the chunked run also equals
    the run in one call (GibbsEngine draws at absolute epoch indices);
    under auto the kernels' seed restarts each chunk
    (numbskull_tpu/numbskull.py:343-349), so resume-exactness is the
    guarantee."""
    from numbskull_tpu_torch.observability import metrics
    src = coin_fixture(str(tmp_path / "coin"))
    eng = ["--engine", engine]
    whole = _cli_out(src, str(tmp_path / "a"), "-i", "120", *eng)
    ck = str(tmp_path / "ck.npz")
    chunked = _cli_out(src, str(tmp_path / "b"), "-i", "120", *eng,
                       "--checkpoint", ck, "--checkpoint_every", "40")
    if engine == "xla":
        assert chunked == whole
    ck2 = str(tmp_path / "ck2.npz")
    _cli_out(src, str(tmp_path / "x"), "-i", "80", *eng, "--checkpoint",
             ck2, "--checkpoint_every", "40")
    metrics.reset()
    resumed = _cli_out(src, str(tmp_path / "c"), "-i", "120", *eng,
                       "--checkpoint", ck2, "--checkpoint_every", "40")
    assert resumed == chunked
    counters = metrics.snapshot()["counters"]
    assert counters["inference.resumes"] == 1
    assert counters["inference.epochs"] == 40


@pytest.mark.parametrize("engine", ["xla", "auto"])
def test_cli_learning_checkpoint_resume(tmp_path, engine):
    """--checkpoint covers learning (tests/test_cli.py:69-97): weights,
    both chains and the step size's epoch index go to <ck>.learn; a
    learning run interrupted after 80 epochs and resumed to 120 writes
    the uninterrupted chunked run's weights, byte for byte, and counts
    one resume; relaunching the finished run with diagnostics on (no -q)
    does not crash."""
    from numbskull_tpu_torch.observability import metrics
    src = coin_fixture(str(tmp_path / "coin"))
    eng = ["--engine", engine]
    ck = str(tmp_path / "ck.npz")
    chunked = _cli_out(src, str(tmp_path / "a"), "-l", "120", "-i", "5",
                       *eng, "--checkpoint", ck, "--checkpoint_every", "40")
    assert os.path.exists(ck + ".learn")
    ck2 = str(tmp_path / "ck2.npz")
    _cli_out(src, str(tmp_path / "x"), "-l", "80", "-i", "5", *eng,
             "--checkpoint", ck2, "--checkpoint_every", "40")
    metrics.reset()
    resumed = _cli_out(src, str(tmp_path / "c"), "-l", "120", "-i", "5",
                       *eng, "--checkpoint", ck2, "--checkpoint_every", "40")
    assert resumed[1] == chunked[1]
    assert float(chunked[1].split()[1]) != 0.0        # learning moved it
    counters = metrics.snapshot()["counters"]
    assert counters["learning.resumes"] == 1
    assert counters["learning.epochs"] == 40
    port_cli.main([src, "-l", "120", "-i", "5", "-o", str(tmp_path / "c"),
                   "--seed", "5", "--device", "cpu", *eng, "--checkpoint",
                   ck2, "--checkpoint_every", "40"])


def test_cli_checkpoint_every_zero_terminates(tmp_path):
    """--checkpoint_every 0 clamps to 1 (tests/test_cli.py:100-105): the
    run ends, its checkpoint holds 3 epochs."""
    from numbskull_tpu_torch.checkpoint import load_checkpoint
    src = coin_fixture(str(tmp_path / "coin"))
    ck = str(tmp_path / "ck.npz")
    port_cli.main([src, "-i", "3", "-o", str(tmp_path), "-q", "--device",
                   "cpu", "--checkpoint", ck, "--checkpoint_every", "0"])
    assert os.path.exists(ck)
    assert load_checkpoint(ck, "cpu")[2] == {"epochs_done": 3}


def test_remaining_api_surface():
    """burnIn, getFactorGraph, device_memory_stats and is_coordinator
    (tests/test_cli.py:150-164): burnIn moves the free chain and tallies
    nothing, on the kernels and on --engine xla."""
    from numbskull_tpu_torch.observability import device_memory_stats
    from numbskull_tpu_torch.parallel.multihost import is_coordinator

    for engine in ("auto", "xla"):
        ns = port_cli.NumbSkull(quiet=True, device="cpu", engine=engine)
        ns.loadFactorGraph(*coin_model(40, evidence=True))
        fg = ns.getFactorGraph(0)
        before = fg.state.var_value.clone()
        fg.burnIn(3, sample_evidence=True)
        assert fg is ns.factorGraphs[0]
        assert not torch.equal(fg.state.var_value, before)
        assert int(fg.state.count.sum()) == 0
        assert fg.inference_epochs_done == 0
    stats = device_memory_stats()
    assert isinstance(stats, list) and "device" in stats[0]
    assert is_coordinator() is True        # single-process


def test_cli_engine_hbm_writes_the_itemgrid_bytes(tmp_path):
    """--engine hbm runs the same kernels as --engine itemgrid (the port
    keeps every graph in device memory): byte-identical output files,
    learning included."""
    src = coin_fixture(str(tmp_path / "coin"))
    out = {}
    for engine in ("hbm", "itemgrid"):
        d = str(tmp_path / engine)
        port_cli.main([src, "-l", "5", "-i", "20", "-b", "2", "-q", "-o", d,
                       "--device", "cpu", "--engine", engine])
        out[engine] = [open(os.path.join(d, name), "rb").read() for name in
                       ("inference_result.out.text",
                        "inference_result.out.weights.text")]
    assert out["hbm"] == out["itemgrid"]
    assert all(out["hbm"])


def _weights(path):
    rows = np.loadtxt(os.path.join(path, "inference_result.out.weights.text"),
                      ndmin=2)
    return rows[:, 1]


def test_cli_learning_recovers_coin_weights(tmp_path):
    """-l 150 on the 4000-copy coin graph with evidence drawn from the
    exact joint (the settings of tests/test_learning.py:29-40): the
    port's weights within 0.15 of the truth (0.8, -0.5, 0.4) and of the
    JAX CLI's weights on the same files (measured 0.005 apart)."""
    src = str(tmp_path / "coin")
    w, v, f, fm, _, _ = coin_model(4000, 0.8, -0.5, 0.4, evidence=True,
                                   weight_init=(0.0, 0.0, 0.0),
                                   fixed=False, seed=3)
    port_dl.write_factor_graph_files(src, w, v, f, fm)
    args = [src, "-l", "150", "-s", "0.1", "-d", "0.99", "-r", "1e-4",
            "-b", "10", "-i", "10", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    ns = port_cli.main(args + ["-o", out_p, "--device", "cpu"])
    jax_cli.main(args + ["-o", out_j])
    w_p, w_j = _weights(out_p), _weights(out_j)
    assert np.abs(w_p - [0.8, -0.5, 0.4]).max() < 0.15
    assert np.abs(w_p - w_j).max() < 0.15
    fg = ns.getFactorGraph()
    np.testing.assert_allclose(fg.getWeights(), w_p, atol=5e-7)
    # inference continued from the learned free chain, on the CPU
    assert fg.state.var_value.device == torch.device("cpu")
    assert fg.learning_total_time > 0


def test_cli_learning_card64_matches_xla_engine(tmp_path):
    """A 24x24 Potts graph of cardinality 64 with 30 % evidence in
    4x4 blocks of equal values: the JAX package learns it through its
    XLA GibbsEngine (cardinality above the TPU learn kernel's 32), the
    port through its learn kernel's plain version. The learned coupling
    must agree within 0.15 (three seeds of each measured 1.18-1.24, so
    0.15 is about three times their spread) and be clearly positive."""
    n = 24
    w, v, f, fm, _, _ = potts_grid(n, n, card=64, weight=0.0, fixed=False)
    r, c = np.divmod(np.arange(n * n), n)
    v["initialValue"] = ((r // 4) * 3 + c // 4) % 64
    v["isEvidence"] = (np.random.default_rng(0).random(n * n) <
                       0.3).astype(np.int8)
    src = str(tmp_path / "potts64")
    port_dl.write_factor_graph_files(src, w, v, f, fm)
    args = [src, "-l", "80", "-s", "0.05", "-d", "0.96", "-r", "0.01",
            "-b", "5", "-i", "5", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    port_cli.main(args + ["-o", out_p, "--device", "cpu"])
    nj = jax_cli.main(args + ["-o", out_j])
    assert nj.factorGraphs[0]._itemgrid.get(True) is None   # XLA engine
    w_p, w_j = _weights(out_p), _weights(out_j)
    assert w_p[0] > 0.8 and w_j[0] > 0.8
    assert abs(w_p[0] - w_j[0]) < 0.15


def test_cli_learning_diagnostics(tmp_path, capsys):
    """Not quiet: the learning line of the JAX CLI, and with --verbose
    every weight (diagnosticsLearning)."""
    src = coin_fixture(str(tmp_path / "coin"))
    port_cli.main([src, "-l", "3", "-i", "2", "-o", str(tmp_path / "o"),
                   "--device", "cpu", "--verbose"])
    out = capsys.readouterr().out
    assert "FACTOR 0: learning 3 epochs took" in out
    assert "weightId: 0" in out and "isFixed: False" in out


def test_port_imports_no_jax():
    """In a fresh interpreter, after a learning and an inference run on
    the CPU (engine 'hbm'), a lattice run, the graph-sharded engine's
    run, run_emulated and learn, both partitioned engines, checkpointed
    learning and inference under engine 'xla' inside a profiler trace,
    run_resilient, device_memory_stats, a sqlite round trip through
    dbsource, a graph the kernels refuse (cardinality 130, on the
    tensor-op engine), both gathers and an import of every experiment
    driver: no jax and no numbskull_tpu (the test process has imported
    both)."""
    code = ("import sys\n"
            "import numbskull_tpu_torch.numbskull as cli\n"
            "import numbskull_tpu_torch.convert\n"
            "import numbskull_tpu_torch.ops._build\n"
            "import numbskull_tpu_torch.ops.gibbs\n"
            "import numbskull_tpu_torch.ops.itemgrid\n"
            "from numbskull_tpu_torch.ops.stencil import GridGibbsEngine\n"
            "from numbskull_tpu_torch.models import coin_model\n"
            "ns = cli.NumbSkull(n_learning_epoch=2, n_inference_epoch=2,\n"
            "                   quiet=True, device='cpu', engine='hbm')\n"
            "ns.loadFactorGraph(*coin_model(4))\n"
            "ns.learning(out=False)\n"
            "ns.inference(out=False)\n"
            "g = GridGibbsEngine(4, 5, 0.3, device='cpu')\n"
            "g.inference(g.init_state(), seed=1, epochs=3, burn=1)\n"
            "from numbskull_tpu_torch.ops.itemgrid_mc import "
            "MultiChipItemGridEngine\n"
            "import numbskull_tpu_torch.parallel.multihost\n"
            "mc = MultiChipItemGridEngine(ns.factorGraphs[0].cg, n_shards=2,\n"
            "                             device='cpu')\n"
            "mc.run(1, 1, 2)\n"
            "mc.run_emulated(1, 1, 2)\n"
            "mc.learn(1, 1, 2, 0.1)\n"
            "import numpy as np, torch\n"
            "from numbskull_tpu_torch.parallel import bsp, partition\n"
            "m = coin_model(4)\n"
            "part = np.arange(8) % 2\n"
            "b = bsp.BSPItemGridInference(*m[:4], part, mode='messages',\n"
            "                             device='cpu')\n"
            "b.learn(1, 1, 0.1)\n"
            "b.inference(1, 2)\n"
            "e = bsp.BSPEngine(*m[:4], part, device='cpu')\n"
            "e.inference(e.init_states(), torch.Generator(), 2)\n"
            "import os, sqlite3, tempfile\n"
            "from numbskull_tpu_torch import dbsource\n"
            "from numbskull_tpu_torch.resilience import run_resilient\n"
            "from numbskull_tpu_torch.observability import (annotate, "
            "device_memory_stats, trace)\n"
            "tmp = tempfile.mkdtemp()\n"
            "ns = cli.NumbSkull(n_learning_epoch=2, n_inference_epoch=2,\n"
            "                   quiet=True, device='cpu', engine='xla',\n"
            "                   checkpoint=os.path.join(tmp, 'ck'))\n"
            "ns.loadFactorGraph(*coin_model(4))\n"
            "ns.learning(out=False)\n"
            "with trace(tmp), annotate('x'):\n"
            "    ns.inference(out=False)\n"
            "g = ns.factorGraphs[0].engine(True)\n"
            "run_resilient(g, g.init_state(), 1, 4, os.path.join(tmp, 'r'),"
            " chunk=2)\n"
            "device_memory_stats()\n"
            "c = sqlite3.connect(':memory:').cursor()\n"
            "dbsource.write_graph_to_db(c, 'coin', *m[:4])\n"
            "dbsource.get_fg_data(c)\n"
            "from numbskull_tpu_torch.models import potts_grid\n"
            "from numbskull_tpu_torch.ops.gibbs import GibbsEngine\n"
            "ns = cli.NumbSkull(n_learning_epoch=2, n_inference_epoch=2,\n"
            "                   quiet=True, device='cpu')\n"
            "ns.loadFactorGraph(*potts_grid(2, 2, card=130, fixed=False))\n"
            "ns.learning(out=False)\n"
            "ns.inference(out=False)\n"
            "assert isinstance(ns.factorGraphs[0].engine(True), "
            "GibbsEngine)\n"
            "from numbskull_tpu_torch.ops import gather\n"
            "x = torch.ones(64)\n"
            "gather.gather_sum(x, torch.zeros((2, 8), dtype=torch.int32), 2)\n"
            "gather.shifted_sum(x, torch.tensor([0, 1], dtype=torch.int32),"
            " 8, 2, 2)\n"
            "import numbskull_tpu_torch.benchutil\n"
            "for name in ('micro_gather', 'micro_gather2', "
            "'micro_gather_xla', 'degree_sweep', 'hbm_scale', "
            "'engine_tradeoff', 'profile_itemgrid', 'sweep_rates', "
            "'lattice_rates', 'lattice_tiles', 'gather_rates'):\n"
            "    __import__('numbskull_tpu_torch.experiments.' + name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'numbskull_tpu' or "
            "m.startswith('numbskull_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
