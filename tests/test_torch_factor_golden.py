"""The port's copy of ``golden`` and the plain potentials against the
JAX package's ``golden``, for every factor function, on the CPU; and a
data-programming model through both CLIs.

For each of the 25 factor codes, every single-code random graph of
``chip_smoke.py`` phase 13 (a) (``chip_smoke.factor_fixtures_of``: kinds
``a14``, ``a13`` where the arity is free, ``hub`` and ``cat``; dyadic
weights): ``numbskull_tpu_torch.golden`` equals ``numbskull_tpu.golden``
(every factor's value at every candidate, every potential), and the
plain potentials (``ops/gibbs.color_potentials``) are within 1e-4 x
max(1, |potential|) of ``golden.potential`` (golden sums in float64). Then a DP generative
model (``chip_smoke.dp_graph``, 2,000 candidates, 10 LFs) through the
port's CLI on the kernels' plain versions and the JAX CLI, compared
statistically.
"""

import os

import numpy as np
import pytest
import torch

from numbskull_tpu import golden as jax_golden
from numbskull_tpu.numbskull import main as jax_main
from numbskull_tpu_torch import dataloading
from numbskull_tpu_torch import golden
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.numbskull import main as port_main
from numbskull_tpu_torch.ops.gibbs import color_potentials, plan_tensors
from numbskull_tpu_torch.ops.itemgrid import present_types_of

import chip_smoke
from _torch_threads import cap_threads

cap_threads()

CODES = sorted(T.FACTORS)


@pytest.mark.parametrize("name", CODES)
def test_golden_copy_and_plain_potentials(name):
    """The port's golden == numbskull_tpu.golden (every factor at every
    candidate of each of its variables, every potential), and the plain
    potentials of every color within 1e-4 x max(1, |potential|) of
    golden.potential (float32 sums against float64 ones: a hub row's
    1,100 RATIO terms sum to about 65, 9e-5 off), at a random state of
    every graph of the code."""
    for i, (gname, _, (w, v, f, fm)) in enumerate(
            chip_smoke.factor_fixtures_of(name)):
        rng = np.random.default_rng(i)
        x = rng.integers(0, 1 << 30, len(v)) % v["cardinality"]
        wv = w["initialValue"].astype(np.float32)
        for fid in range(len(f)):
            o, a = int(f["ftv_offset"][fid]), int(f["arity"][fid])
            for vid in set(fm["vid"][o:o + a].tolist()):
                for k in range(int(v["cardinality"][vid])):
                    assert golden.eval_factor(fid, vid, k, v, f, fm, x) == \
                        jax_golden.eval_factor(fid, vid, k, v, f, fm, x)
        cg = compile_graph(w, v, f, fm)
        for p in cg.plans:
            pot = color_potentials(plan_tensors(p, "cpu"), p.kmax,
                                   present_types_of(p.it_ftype),
                                   torch.as_tensor(x.astype(np.int32)),
                                   torch.as_tensor(wv)).numpy()
            for r, vid in enumerate(p.cv_vid[p.cv_valid]):
                for k in range(int(v["cardinality"][vid])):
                    want = golden.potential(v, f, fm, wv, int(vid), k, x)
                    assert want == jax_golden.potential(
                        v, f, fm, wv, int(vid), k, x), gname
                    assert abs(float(pot[r, k]) - want) <= \
                        1e-4 * max(1.0, abs(want)), (gname, int(vid), k)


def test_golden_exact_marginals_copy():
    """golden.exact_marginals of the port == the JAX package's on phase
    13 (c)'s three graphs."""
    for gname, (w, v, f, fm) in chip_smoke.exact_fixtures():
        np.testing.assert_array_equal(
            golden.exact_marginals(v, f, fm, w["initialValue"]),
            jax_golden.exact_marginals(v, f, fm, w["initialValue"]),
            err_msg=gname)


DP_CANDIDATES = 2000
# three times the largest spread (max - min) over seeds 0, 1, 2 of the
# port's CLI (--engine itemgrid, CPU) and the JAX CLI (--engine xla) on
# this graph at DP_ARGV: 0.01355 (JAX) and 0.00295 (JAX), as
# `PYTHONPATH=. python tests/test_torch_factor_golden.py` prints them
DP_MEAN_TOL = 3 * 0.01355
DP_WEIGHT_TOL = 3 * 0.00295


def _dp_outputs(out):
    rows = np.loadtxt(os.path.join(out, "inference_result.out.text"),
                      ndmin=2)
    w = np.loadtxt(os.path.join(out, "inference_result.out.weights.text"),
                   ndmin=2)[:, 1]
    return rows, w


def _write_dp(out_dir):
    dataloading.write_factor_graph_files(
        os.path.join(out_dir, "g"),
        *chip_smoke.dp_graph(DP_CANDIDATES, chip_smoke.DP_LFS, 5))


def _dp_runs(out_dir, seed):
    """The port's and the JAX CLI's outputs on the DP graph at ``seed``
    (the test's runs; seed 0 is the CLIs' default)."""
    args = [os.path.join(out_dir, "g"), *chip_smoke.DP_ARGV, "-q",
            "--seed", str(seed)]
    port_main(args + ["-o", os.path.join(out_dir, "p%d" % seed), "--engine",
                      "itemgrid", "--device", "cpu"])
    jax_main(args + ["-o", os.path.join(out_dir, "j%d" % seed), "--engine",
                     "xla"])
    return [_dp_outputs(os.path.join(out_dir, w + str(seed)))
            for w in ("p", "j")]


def test_dp_cli_port_vs_jax(tmp_path):
    """The DP graph (2,000 candidates, 10 LFs, 22,000 variables, 90,000
    factors) through ``chip_smoke.DP_ARGV`` (-l 20 -i 100 -b 10) in the
    port's CLI (``--engine itemgrid --device cpu``: the kernels' plain
    versions) and the JAX CLI (``--engine xla``, the JAX package's
    engine on the CPU). The class variables' mean marginal and every
    learned weight agree within DP_MEAN_TOL and DP_WEIGHT_TOL, and the
    weights moved further than that from where they started."""
    _write_dp(str(tmp_path))
    (rp, wp), (rj, wj) = _dp_runs(str(tmp_path), 0)
    assert rp.shape == rj.shape and wp.shape == wj.shape == (45,)
    np.testing.assert_array_equal(rp[:, :2], rj[:, :2])
    cls = np.arange(DP_CANDIDATES) * (1 + chip_smoke.DP_LFS)
    sel = np.isin(rp[:, 0], cls)
    assert sel.sum() == DP_CANDIDATES
    assert abs(rp[sel, 2].mean() - rj[sel, 2].mean()) <= DP_MEAN_TOL
    assert np.abs(wp - wj).max() <= DP_WEIGHT_TOL
    assert np.abs(wp - chip_smoke.dp_graph(
        DP_CANDIDATES, chip_smoke.DP_LFS, 5)[0]["initialValue"]).max() > \
        3 * DP_WEIGHT_TOL


if __name__ == "__main__":
    # the spreads that DP_MEAN_TOL and DP_WEIGHT_TOL are three times of
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        _write_dp(tmp)
        runs = [_dp_runs(tmp, seed) for seed in (0, 1, 2)]
    cls = np.arange(DP_CANDIDATES) * (1 + chip_smoke.DP_LFS)
    for i, who in enumerate(("port itemgrid", "JAX xla")):
        means = [r[i][0][np.isin(r[i][0][:, 0], cls), 2].mean()
                 for r in runs]
        ws = np.stack([r[i][1] for r in runs])
        print("%s: class mean spread %.5f, largest weight spread %.5f"
              % (who, np.ptp(means), np.ptp(ws, axis=0).max()))
