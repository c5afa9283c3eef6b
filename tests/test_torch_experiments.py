"""The port's experiment drivers (numbskull_tpu_torch/experiments) and
their timing helper (numbskull_tpu_torch/benchutil), on the CPU at tiny
sizes: each driver writes its TSV with the JAX driver's columns plus the
port's, a first line naming the device, and rows that check out."""

import math
import os
import subprocess
import sys

import pytest

from numbskull_tpu_torch import benchutil
from numbskull_tpu_torch.experiments import (common, degree_sweep,
                                             engine_tradeoff, gather_rates,
                                             hbm_scale,
                                             lattice_rates, lattice_tiles,
                                             micro_gather, micro_gather2,
                                             micro_gather_xla,
                                             multiproc_scaling,
                                             profile_itemgrid, scaling,
                                             sweep_rates)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX drivers' columns (their TSV headers, or the fields they print)
# and the port's additions
MICRO = (["mode", "trw", "ng", "iters", "ok", "ms"],           # :150-151
         ["gpu_form", "Gvals_per_s", "R", "x_bytes", "x_in", "spread_ms",
          "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share",
          "sector_bound_ms", "noreuse_ms", "max_abs_err"])
COLUMNS = {
    "micro_gather": MICRO,
    "micro_gather2": MICRO,
    "micro_gather_xla": (["V", "N", "iters", "ok", "elem_per_s"],  # :102
                         ["variant", "dt_s", "spread_s"]),
    "degree_sweep": (["degree", "n_vars", "n_colors", "engine",   # :37-38
                      "compile_s", "epoch_ms", "updates_per_s"],
                     ["learn_epoch_ms", "learn_updates_per_s"]),
    "hbm_scale": (["n_vars", "grid", "sr_rows", "compile_s",      # :33
                   "epoch_ms", "updates_per_s"],
                  ["engine_build_s", "updates_per_s_spread"]),
    "engine_tradeoff": (["graph", "n_vars", "n_colors", "xla_ups",  # :70
                         "itemgrid_ups", "note"], ["lattice_ups"]),
    "profile_itemgrid": (["config"],                              # :67-73
                         ["phase", "kernel", "device_ms_per_epoch",
                          "epoch_ms", "busy_share", "median_gap_us"]),
    "scaling": (["chains", "graph", "epoch_ms",                 # :48
                 "total_updates_per_s", "efficiency"], []),
    "multiproc_scaling": (["engine", "nproc", "devs_per_proc",   # :87-88
                           "n_vars", "epoch_ms", "updates_per_s",
                           "vs_1proc"], ["mesh"]),
    "sweep_rates": ([], sweep_rates.HEADER),    # no JAX counterpart
    "lattice_rates": ([], lattice_rates.HEADER),
    "gather_rates": ([], gather_rates.HEADER),
}

RUNS = {
    "micro_gather": lambda p: micro_gather.run(
        p, "cpu", timing=(("f32_row", 16, 3, 4), ("roll_unr", 8, 3, 4)),
        sweep_r=2048, sweep_ng=5,
        sweep_x=(("sweep_A", 4096), ("sweep_B", 1 << 14))),
    "micro_gather2": lambda p: micro_gather2.run(
        p, "cpu", timing=((16, 3, 4),), sweep_r=1024, sweep_ng=3,
        sweep_nx=1 << 14),
    "micro_gather_xla": lambda p: micro_gather_xla.run(p, 1024, 4096, 3,
                                                       "cpu"),
    "degree_sweep": lambda p: degree_sweep.run(
        p, 600, (1, 5), "cpu", points=((1, 3), (1, 2))),
    "hbm_scale": lambda p: hbm_scale.run(p, ((8, 16),), "cpu",
                                         points=(1, 3)),
    "engine_tradeoff": lambda p: engine_tradeoff.run(p, "cpu", scale=0.01,
                                                     epochs=2),
    "profile_itemgrid": lambda p: profile_itemgrid.run(p, 8, 2, "cpu",
                                                       scale=0.001),
    "scaling": lambda p: scaling.run(p, 6, "cpu", n_dev=4,
                                     points=(1, 2)),
    "multiproc_scaling": lambda p: multiproc_scaling.run(
        p, 16, 3, "cpu", meshes=(2,), timeout=120),
    "sweep_rates": lambda p: sweep_rates.run(p, "cpu", scale=0.0005,
                                             points=(1, 3)),
    "lattice_rates": lambda p: lattice_rates.run(p, "cpu", sides=(8, 12),
                                                 points=(1, 3)),
    "gather_rates": lambda p: gather_rates.run(
        p, "cpu", sizes=(("sweep_A", 4096), ("sweep_B", 1 << 14)),
        sweep_r=2048, sweep_ng=5, span_nx=1 << 15,
        timing=(("f32_row", 16, 3, 4), ("bf16_row", 16, 3, 4),
                ("roll", 8, 3, 4)), timing2=((16, 3, 4),), calls=2),
}


def _number(s):
    return float(s) if s not in ("-", "") else None


def test_gather_rates_label(tmp_path):
    """``label`` (``--label``) fills the checkout column, so that the
    turns against another checkout name themselves in their TSVs."""
    path = str(tmp_path / "rates.tsv")
    gather_rates.run(path, "cpu", sizes=(("sweep_A", 512),), sweep_r=64,
                     sweep_ng=3, span_nx=1024, timing=(), timing2=(),
                     calls=1, label="parent, turn 1")
    _, _, rows = common.read_tsv(path)
    assert [(r["row"], r["checkout"]) for r in rows] == [
        ("sweep_A", "parent, turn 1"), ("sweep_span8", "parent, turn 1"),
        ("span8_aligned", "parent, turn 1")]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_driver_writes_its_tsv(tmp_path, name):
    path = str(tmp_path / (name + ".tsv"))
    RUNS[name](path)
    first, header, rows = common.read_tsv(path)
    assert first.startswith("# cpu: ")
    jax_cols, port_cols = COLUMNS[name]
    assert set(jax_cols) <= set(header) and set(port_cols) <= set(header)
    assert rows and all(len(r) == len(header) for r in rows)
    if "ok" in header:
        assert all(r["ok"] == "True" for r in rows)
    if name == "degree_sweep":
        assert [r["engine"] for r in rows] == ["itemgrid", "itemgrid"]
        assert all(_number(r["learn_updates_per_s"]) > 0 for r in rows)
    if name == "hbm_scale":
        assert rows[0]["sr_rows"] == "-"
        assert rows[0]["engine"] == "ItemGridEngine"
    if name == "engine_tradeoff":
        assert [r["lattice_ups"] != "-" for r in rows] == \
            [r["graph"].startswith("ising") for r in rows]
        assert all(_number(r["xla_ups"]) > 0 and
                   _number(r["itemgrid_ups"]) > 0 for r in rows)
    if name == "profile_itemgrid":
        alls = [r for r in rows if r["kernel"] == "all"]
        assert [(r["config"], r["phase"]) for r in alls] == [
            (c, p) for c in ("ising8", "voting_deg10", "voting_deg50")
            for p in ("infer", "learn")]
        assert all(0 < _number(r["busy_share"]) for r in alls)
    if name == "scaling":
        assert [(r["chains"], r["graph"]) for r in rows] == [
            ("1", "4"), ("2", "2"), ("4", "1")]
        assert rows[0]["efficiency"] == "1.000"
        assert all(_number(r["total_updates_per_s"]) > 0 for r in rows)
    if name == "multiproc_scaling":
        assert [(r["engine"], r["nproc"], r["devs_per_proc"])
                for r in rows] == [("sharded", "1", "2"),
                                   ("sharded", "2", "1"), ("bsp", "1", "4")]
        assert rows[0]["vs_1proc"] == "1.000"
        assert all(_number(r["updates_per_s"]) > 0 for r in rows)
    if name == "sweep_rates":
        assert [r["graph"] for r in rows] == [
            "ising22", "coin200", "lf100", "potts5_card32", "potts5_card128",
            "voting_deg10", "voting_deg50"]
        assert [int(r["kmax"]) for r in rows] == [2, 2, 3, 32, 128, 2, 2]
        assert all(_number(r["epoch_ms"]) > 0 for r in rows)
        assert {r["checkout"] for r in rows} == {REPO}
    if name == "lattice_rates":
        assert [(r["side"], r["cells"]) for r in rows] == \
            [("8", "64"), ("12", "144")]
        assert all(_number(r["sweep_ms"]) > 0 for r in rows)
        assert {r["checkout"] for r in rows} == {REPO}
    if name == "gather_rates":
        assert [(r["row"], r["modes"]) for r in rows] == [
            ("sweep_A", "-"), ("sweep_B", "-"), ("sweep_span8", "-"),
            ("span8_aligned", "-"), ("tpu_trw16", "f32_row+bf16_row"),
            ("tpu_trw8", "roll"), ("tpu_trw16", "roll64"),
            ("tpu_trw16", "fact+take")]
        assert [r["noreuse_ms"] != "-" for r in rows[:4]] == [
            False, False, True, True]
        assert all(_number(r["call_ms"]) > 0 and r["device_ms"] == "-"
                   for r in rows)
        assert {r["checkout"] for r in rows} == {REPO}
    if name.startswith("micro_gather") and name != "micro_gather_xla":
        assert all(float(r["max_abs_err"]) == 0 for r in rows)
        sweep = [r for r in rows if r["mode"].startswith("sweep")]
        assert sweep and all(_number(r["bound_ms"]) > 0 and
                             _number(r["library_ms"]) > 0 for r in sweep)
        modes = {r["mode"] for r in rows} - {r["mode"] for r in sweep}
        assert modes == set(micro_gather.MODES if name == "micro_gather"
                            else micro_gather2.MODES)


def test_lattice_tiles_needs_the_card(tmp_path):
    """The plan sweep times the CUDA kernel: on the CPU it raises rather
    than time anything else, and writes nothing."""
    out = tmp_path / "tiles.tsv"
    with pytest.raises(RuntimeError, match="cuda"):
        lattice_tiles.run(str(out), "cpu", sides=(8,),
                          candidates=((8, 8, 1, 2, 1),))
    assert not out.exists()


def test_driver_command_line(tmp_path):
    """``python -m ...micro_gather_xla OUT V N iters --device cpu``: the
    JAX driver's arguments after the output path."""
    out = str(tmp_path / "x.tsv")
    subprocess.run([sys.executable, "-m",
                    "numbskull_tpu_torch.experiments.micro_gather_xla", out,
                    "256", "512", "2", "--device", "cpu"], cwd=REPO,
                   check=True, timeout=120, capture_output=True)
    _, _, rows = common.read_tsv(out)
    assert [(r["V"], r["N"], r["iters"]) for r in rows] == \
        [("256", "512", "2")] * 5


def _runner(calls):
    def run(epochs, rep):
        calls.append(epochs)
        return sum(math.sqrt(i) for i in range(2000 * epochs))
    return run


def test_epoch_rate_on_the_cpu():
    """A positive rate and seconds per epoch from a synthetic runner whose
    time grows with the epoch count; the warm-up runs 2 epochs."""
    calls = []
    ups, per = benchutil.epoch_rate(_runner(calls), 100, lo=1, hi=20,
                                    reps=2, device="cpu", min_delta=0.0)
    assert ups > 0 and per > 0 and calls[:3] == [2, 1, 1]


def test_median_rate_on_the_cpu():
    """The median rate, the spread of n rates and the median seconds per
    epoch."""
    ups, spread, per = benchutil.median_rate(_runner([]), 100, lo=1, hi=20,
                                             n=3, device="cpu",
                                             min_delta=0.0)
    assert ups > 0 and spread >= 0 and per > 0
    ms, sp = benchutil.median_ms(lambda: sum(range(10000)), "cpu", n=3)
    assert ms > 0 and sp >= 0
