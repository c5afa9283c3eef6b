"""`engine="hbm"` in the port against the JAX package's HBM-resident
kernels, on the CPU.

The JAX package serves graphs beyond the TPU's VMEM cap with
``HbmItemGridEngine`` (``_make_kernel_hbm``, ``_make_learn_kernel_hbm``),
bit-identical to the VMEM kernels on the software-PRNG path
(tests/test_itemgrid.py:721-790). The port keeps every graph in device
memory already, so ``engine="hbm"`` runs the port's itemgrid kernels;
here their plain versions (CPU tensors) run under a schedule derived
from the HBM engine's own plan (planned with ``n_shards=HG``: every color
padded to whole groups of HG row blocks), and must equal the interpret-
mode HBM kernels with tolerance 0 (dyadic weights and integer gradient
sums make every sum exact in any order).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import ising_color_hint, ising_grid
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.compile import compile_graph as port_compile_graph
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.models import ising_grid as port_ising_grid
from numbskull_tpu_torch.models import potts_grid as port_potts_grid
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import GibbsEngine
from test_torch_itemgrid import schedule_from_jax_plan
from test_torch_learn import learn_schedule_from_jax_plan

from _torch_threads import cap_threads

cap_threads()

N, M = 160, 512        # 81,920 variables: above the HBM engine's floor


def _hbm_engines(weight, fixed, evidence_frac, learn, allow_aff=None):
    w, v, f, fm, dm, _ = ising_grid(N, M, weight=weight, fixed=fixed)
    if evidence_frac:
        rng = np.random.default_rng(0)
        v["isEvidence"] = (rng.random(N * M) < evidence_frac).astype(np.int8)
    cg = jax_compile_graph(w, v, f, fm, domain_mask=dm,
                           color_hint=ising_color_hint(N, M))
    hbm = jig.HbmItemGridEngine(cg, interpret=True, allow_aff=allow_aff)
    plan = copy.copy(hbm.plan)
    assert (plan.cmeta[:, 1] % jig.HG == 0).all()       # grouped colors
    if not hbm.allow_aff:              # every color on the old path
        plan.cmeta = plan.cmeta.copy()
        plan.cmeta[:, 5] = 0
    sched = (learn_schedule_from_jax_plan if learn else
             schedule_from_jax_plan)(cg, plan)
    port = pig.ItemGridEngine(
        compiled_graph_from_reference(dataclasses.asdict(cg)),
        device="cpu", schedule=sched)
    return hbm, port


@pytest.mark.parametrize("allow_aff", [True, False])
def test_hbm_inference_matches_tpu_hbm_kernel_interpret(allow_aff):
    """ItemGridEngine.run (plain path) == HbmItemGridEngine(interpret=True)
    .run on the 160x512 Ising of tests/test_itemgrid.py:730-739, with the
    affine path (`tile`/`sigmoid2`, the interpret default) and without it
    (`row`/`cdf`, the TPU hardware default)."""
    hbm, port = _hbm_engines(0.35, True, 0.0, learn=False,
                             allow_aff=allow_aff)
    assert set(port.schedule.maps) == {"tile" if allow_aff else "row"}
    x_ref, c_ref = hbm.run(seed=3, burn=2, epochs=8)
    x, c = port.run(3, 2, 8)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_hbm_learn_matches_tpu_hbm_kernel_interpret():
    """ItemGridEngine.learn (plain path) == HbmItemGridEngine(interpret=
    True).learn(return_state=True): weights and both chains, with 30 %
    evidence (tests/test_itemgrid.py:767-790), burn 1, 2 epochs."""
    hbm, port = _hbm_engines(0.2, False, 0.3, learn=True)
    w_ref, x_ref, xe_ref = hbm.learn(seed=2, burn=1, epochs=2,
                                     stepsize=0.05, return_state=True)
    w, x, xe = port.learn(2, 1, 2, 0.05)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_array_equal(xe.numpy(), np.asarray(xe_ref))
    assert float(w[0]) != pytest.approx(0.2)            # the weight moved


def _potts_card64():
    w, v, f, fm, dm, _ = port_potts_grid(8, 16, card=64, weight=0.25)
    return w, v, f, fm, dm


@pytest.mark.parametrize("graph", ["fits_vmem", "card64"])
def test_hbm_runs_graphs_the_tpu_hbm_engine_refuses(graph):
    """The JAX HbmItemGridEngine refuses a graph that fits VMEM and one of
    cardinality above 32 (and falls back to XLA); the port's engine="hbm"
    runs both, with the same results as engine="itemgrid"."""
    if graph == "fits_vmem":
        w, v, f, fm, dm, _ = port_ising_grid(16, 16, weight=0.25)
    else:
        w, v, f, fm, dm = _potts_card64()
    jcg = jax_compile_graph(w, v, f, fm, domain_mask=dm)
    with pytest.raises(ValueError, match="fits VMEM|caps cardinality"):
        jig.HbmItemGridEngine(jcg, interpret=True)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    out = {}
    for engine in ("hbm", "itemgrid"):
        fg = port_cli.FactorGraph(cg, 0, seed=4, device="cpu", engine=engine)
        fg.inference(2, 6, sample_evidence=True)
        out[engine] = fg.state.count.clone()
    assert torch.equal(out["hbm"], out["itemgrid"])
    assert int(out["hbm"].sum()) == 6 * cg.n_vars


def test_factor_graph_engine_argument():
    """FactorGraph takes the JAX package's engine= argument: 'auto',
    'itemgrid' and 'hbm' run the kernels and are counted once per graph;
    'xla' runs the tensor-op GibbsEngine for both sample_evidence flags,
    counted the same way and with no fallback; other names raise."""
    w, v, f, fm, dm, _ = port_ising_grid(8, 8, weight=0.25)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    metrics.reset()
    fg = port_cli.FactorGraph(cg, 0, device="cpu", engine="hbm")
    fg.inference(0, 3, sample_evidence=True)
    fg.inference(0, 3, sample_evidence=True)
    assert metrics.snapshot()["counters"] == {
        "engine.requested.hbm": 1.0, "inference.epochs": 6.0,
        "inference.variable_updates": 6.0 * cg.n_vars}
    metrics.reset()
    fg = port_cli.FactorGraph(cg, 0, device="cpu", engine="xla")
    fg.inference(0, 3, sample_evidence=True)
    assert isinstance(fg.engine(True), GibbsEngine)
    assert fg.engine(False) is fg.engine(True)
    assert int(fg.state.count.sum()) == 3 * cg.n_vars
    assert metrics.snapshot()["counters"] == {
        "engine.requested.xla": 1.0, "inference.epochs": 3.0,
        "inference.variable_updates": 3.0 * cg.n_vars}
    with pytest.raises(ValueError, match="unknown engine"):
        port_cli.FactorGraph(cg, 0, device="cpu", engine="vmem")
    metrics.reset()
    ns = port_cli.NumbSkull(engine="hbm", device="cpu", quiet=True)
    ns.loadFactorGraph(w, v, f, fm, dm, None)
    assert metrics.snapshot()["counters"] == {"engine.requested.hbm": 1.0}


def test_build_tables_refuses_salt_block_overflow():
    """A color with a draw position at or beyond 1024 x 65536 would carry
    its block index into the salt's upper 16 bits: refused."""
    w, v, f, fm, dm, _ = port_ising_grid(4, 4, weight=0.25)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    s = pig.default_schedule(cg)
    last = int(s.upos.max())
    big = dataclasses.replace(s, upos=s.upos + (pig.RB << 16) - last)
    with pytest.raises(ValueError, match="salt"):
        pig.build_tables(cg, big, True, "cpu")
    ok = dataclasses.replace(s, upos=s.upos + (pig.RB << 16) - 1 - last)
    pig.build_tables(cg, ok, True, "cpu")
