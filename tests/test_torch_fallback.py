"""The port's CLI on graphs its kernels refuse, and ``--parts`` on several
devices, on the CPU.

A graph outside the kernels' envelope (cardinality above 128, more than
256 colors, draw positions or item offsets beyond what the kernels
address: ``ops/itemgrid.EnvelopeError``) runs on the tensor-op
``GibbsEngine``, as the JAX CLI runs such graphs on its XLA engine. The
two packages draw from different streams, so outputs agree in
distribution: the tolerances are stated at each test.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from numbskull_tpu import numbskull as jax_cli
from numbskull_tpu_torch import dataloading as port_dl
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.models import potts_grid, voting_model
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops.gibbs import GibbsEngine
from numbskull_tpu_torch.ops.itemgrid import EnvelopeError, ItemGridEngine
from test_torch_host import coin_fixture

from _torch_threads import cap_threads

cap_threads()


def potts130_dir(path):
    """A 4x4 Potts graph of cardinality 130 (beyond the kernels' 128),
    learnable coupling 0.3, 30 % evidence at random values."""
    w, v, f, fm, _, _ = potts_grid(4, 4, card=130, weight=0.3, fixed=False)
    rng = np.random.default_rng(0)
    v["isEvidence"] = (rng.random(16) < 0.3).astype(np.int8)
    v["initialValue"] = rng.integers(0, 130, 16)
    port_dl.write_factor_graph_files(path, w, v, f, fm)
    return path


def voting301_dir(path):
    """voting_model(400, 1, 300): one OR factor over 301 variables, so
    301 colors (beyond the kernels' 256)."""
    w, v, f, fm, _, _ = voting_model(400, 1, 300)
    port_dl.write_factor_graph_files(path, w, v, f, fm)
    return path


def _fallbacks():
    return metrics.snapshot()["counters"].get("engine.fallbacks", 0.0)


def _probs(path):
    return np.loadtxt(os.path.join(path, "inference_result.out.text"),
                      ndmin=2)


def _weights(path):
    return np.loadtxt(os.path.join(
        path, "inference_result.out.weights.text"), ndmin=2)[:, 1]


def test_potts_card130_runs_on_the_tensor_op_engine(tmp_path):
    """-l 20 -i 200 -b 10 under --engine itemgrid: the port warns, counts
    one fallback, learns and infers on GibbsEngine on the CPU and writes
    both files; its marginals are within 0.1 of the JAX CLI's (the two
    measured 0.04 apart: about three Monte-Carlo standard deviations of
    the difference of two 200-epoch chains at p = 1/130, the largest of
    2080 slots) and the learned coupling within 0.05 (measured 0.009)."""
    src = potts130_dir(str(tmp_path / "potts"))
    args = [src, "-l", "20", "-i", "200", "-b", "10", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    before = _fallbacks()
    with pytest.warns(UserWarning, match="--engine itemgrid unavailable "
                      "for this graph.*cardinality 130 > 128"):
        ns = port_cli.main(args + ["-o", out_p, "--device", "cpu",
                                   "--engine", "itemgrid"])
    jax_cli.main(args + ["-o", out_j])
    assert _fallbacks() == before + 1
    fg = ns.getFactorGraph()
    eng = fg.engine(True)
    assert isinstance(eng, GibbsEngine) and eng.device.type == "cpu"
    assert fg.state.count.device.type == "cpu"
    p, j = _probs(out_p), _probs(out_j)
    np.testing.assert_array_equal(p[:, :2], j[:, :2])
    assert np.abs(p[:, 2] - j[:, 2]).max() < 0.1
    assert abs(_weights(out_p)[0] - _weights(out_j)[0]) < 0.05
    assert _weights(out_p)[0] != 0.3          # learning moved it


def test_voting_301_colors_runs_on_the_tensor_op_engine(tmp_path):
    """-i 10 under --engine auto: no warning, one fallback counted, both
    files written; the mean marginal within 0.05 of the JAX CLI's (the
    two measured 0.003 apart at 200 epochs; 10 epochs keep this test to
    seconds, each of the 301 colors is a tensor-op step in both
    packages)."""
    src = voting301_dir(str(tmp_path / "vote"))
    args = [src, "-i", "10", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    before = _fallbacks()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port_cli.main(args + ["-o", out_p, "--device", "cpu"])
    jax_cli.main(args + ["-o", out_j])
    assert _fallbacks() == before + 1
    p, j = _probs(out_p), _probs(out_j)
    np.testing.assert_array_equal(p[:, :2], j[:, :2])
    assert ((p[:, 2] >= 0) & (p[:, 2] <= 1)).all()
    assert abs(p[:, 2].mean() - j[:, 2].mean()) < 0.05
    np.testing.assert_array_equal(_weights(out_p), _weights(out_j))


def test_graph_inside_the_envelope_counts_no_fallback(tmp_path):
    """The coin fixture under --engine itemgrid runs on the kernels'
    plain versions: no warning, no fallback counted."""
    src = coin_fixture(str(tmp_path / "coin"))
    before = _fallbacks()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ns = port_cli.main([src, "-l", "3", "-i", "5", "-q", "-o",
                            str(tmp_path / "o"), "--device", "cpu",
                            "--engine", "itemgrid"])
    assert _fallbacks() == before
    assert isinstance(ns.getFactorGraph().engine(True), ItemGridEngine)


def test_other_value_errors_still_raise(tmp_path, monkeypatch):
    """Only EnvelopeError falls back: a ValueError of any other kind
    from building the kernel engine raises through the CLI, and is not
    counted."""
    def refuse(*args, **kw):
        raise ValueError("x is on cuda:0, expected cpu")

    monkeypatch.setattr(port_cli, "ItemGridEngine", refuse)
    src = coin_fixture(str(tmp_path / "coin"))
    before = _fallbacks()
    with pytest.raises(ValueError, match="expected cpu"):
        port_cli.main([src, "-i", "5", "-q", "-o", str(tmp_path / "o"),
                       "--device", "cpu"])
    assert _fallbacks() == before
    assert issubclass(EnvelopeError, ValueError)


def test_part_devices():
    """--parts takes every card when more than one is visible, else the
    device asked for."""
    cpu = torch.device("cpu")
    assert port_cli.part_devices(cpu) == [cpu]
    if torch.cuda.device_count() < 2:
        assert port_cli.part_devices(torch.device("cuda")) == \
            [torch.device("cuda")]


def test_part_devices_several_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert port_cli.part_devices(torch.device("cuda")) == [
        torch.device("cuda", i) for i in range(3)]
    assert port_cli.part_devices(torch.device("cpu")) == \
        [torch.device("cpu")]


def test_run_distributed_hands_every_device_to_bspengine(tmp_path):
    """run_distributed given two devices builds BSPEngine over both (part
    p on device p), and its output files equal the one-device run's,
    byte for byte (the parts' generators are seeded alike either way)."""
    src = coin_fixture(str(tmp_path / "coin"))
    out = {}
    for name, devices in (("two", ["cpu", "cpu"]), ("one", None)):
        d = str(tmp_path / name)
        ns = port_cli.load([src, "--parts", "2", "-l", "5", "-i", "20",
                            "-b", "2", "-q", "-o", d, "--device", "cpu"])
        res = port_cli.run_distributed(ns, devices=devices)
        assert res["devices"] == (["cpu", "cpu"] if devices else ["cpu"])
        out[name] = [open(os.path.join(d, f), "rb").read() for f in
                     ("inference_result.out.text",
                      "inference_result.out.weights.text")]
    assert out["two"] == out["one"] and all(out["one"])
