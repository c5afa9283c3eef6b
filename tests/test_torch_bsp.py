"""Partitioned (BSP) execution in the port against the JAX package, on
the CPU.

The has_ext forms of the fused kernels: the port's plain versions
(ItemGridEngine on CPU tensors, under a schedule derived from the JAX
plan) against the interpret-mode TPU kernels with the same dyadic
external potentials, bit for bit. The boundary messages against the
JAX package's and against the golden potential restricted to remote
factors. BSPItemGridInference end to end against the JAX class (values
and messages inference, messages learning, and a JAX run continued in
the port), bit for bit. BSPEngine (on the tensor-op GibbsEngine, whose
draws come from torch's generator, not threefry) statistically, and the
CLI's ``--parts``.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from numbskull_tpu import golden
from numbskull_tpu import numbskull as jax_cli
from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.compile import conflict_edges as jax_conflict_edges
from numbskull_tpu.models import coin_model, lf_model
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops.gibbs import LearnParams as JaxLearnParams
from numbskull_tpu.parallel import bsp as jbsp
from numbskull_tpu.parallel import partition as jpart
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.compile import conflict_edges
from numbskull_tpu_torch.convert import (bsp_state_from_reference,
                                         compiled_graph_from_reference)
from numbskull_tpu_torch.models import coin_exact_marginal
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams
from numbskull_tpu_torch.parallel import bsp, partition
from test_bsp import _random_graph
from test_torch_host import coin_fixture
from test_torch_itemgrid import schedule_from_jax_plan

from _torch_threads import cap_threads

cap_threads()


def _dyadic(rng, shape, scale=8, span=2.0):
    """Multiples of 1/scale in [-span, span]: every sum of a few of them
    is exact in float32, in any order."""
    n = int(span * scale)
    return (rng.integers(-n, n + 1, shape) / scale).astype(np.float32)


def _schedules(jax_eng, learn=False):
    """Per part, the port Schedule of the JAX part engine's plan (with
    the learn kernel's slot order when ``learn``)."""
    out = []
    for e in jax_eng.engines:
        s = schedule_from_jax_plan(e.cg, e.plan)
        if learn:
            s = dataclasses.replace(s, arg_rank=np.asarray(e.plan.perm,
                                                           np.int64))
        out.append(s)
    return out


# ---- the has_ext forms of kernels #1 and #2 (plain versions) -----------

def _coin_graph():
    w, v, f, fm, dm, _ = coin_model(64, evidence=False,
                                    weight_init=(0.5, -0.25, 0.5),
                                    fixed=True)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _lf_graph():
    w, v, f, fm, dm, _ = lf_model(0.5, [0.5, 0.25, 0.75], copies=20, seed=1)
    w["initialValue"] = [0.5, 0.25, -0.5, 0.75]
    w["isFixed"] = True
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _categorical_graph():
    w, v, f, fm = _random_graph(seed=3, n_vars=16, n_factors=24,
                                categorical=True)
    w["initialValue"] = [0.5, -0.75, 0.25, 1.0]
    return jax_compile_graph(w, v, f, fm)


EXT_GRAPHS = {
    # name: (graph, ext width relative to kmax)
    "coin_affine": (_coin_graph, +1),      # wider: the extra column unread
    "lf_general": (_lf_graph, 0),
    "categorical": (_categorical_graph, -1),   # narrower: missing = 0
}


@pytest.mark.parametrize("name", sorted(EXT_GRAPHS))
def test_ext_run_matches_tpu_kernel_interpret(name):
    """ItemGridEngine(cg, device='cpu').run(ext_pot=E) ==
    PallasItemGridEngine(cg, interpret=True).run(ext_pot=E): values and
    counts, tolerance 0 (dyadic weights and E)."""
    build, dk = EXT_GRAPHS[name]
    cg = build()
    plan, reason = jig.plan_item_grid(cg, True)
    assert plan is not None, reason
    ext = _dyadic(np.random.default_rng(1), (cg.n_vars, cg.kmax + dk))
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, device="cpu",
                             schedule=schedule_from_jax_plan(cg, plan))
    pig.EXT_LAUNCHES = 0
    x, c = eng.run(4, 1, 6, ext_pot=ext)
    assert pig.EXT_LAUNCHES == 0          # CPU tensors launch nothing
    x_ref, c_ref = jig.PallasItemGridEngine(cg, interpret=True).run(
        seed=4, burn=1, epochs=6, ext_pot=ext)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(c.numpy(), c_ref)
    _, c0 = eng.run(4, 1, 6)
    assert not torch.equal(c0, c), "the potentials must change the draws"
    if name == "coin_affine":
        assert (plan.cmeta[:, 5] == 1).any()       # the _draw2 path
    else:
        assert (plan.cmeta[:, 5] == 0).all()       # the general _draw


def _coin_learn_graph():
    w, v, f, fm, dm, _ = coin_model(100, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _lf_learn_graph():
    w, v, f, fm, dm, _ = lf_model(0.5, [0.5, 0.25, 0.75], copies=30,
                                  seed=1)
    w["isFixed"][2] = True
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


LEARN_GRAPHS = {
    "coin_l2": (_coin_learn_graph, dict(regularization=2, reg_param=1e-4)),
    "lf_l1": (_lf_learn_graph, dict(regularization=1, reg_param=0.01,
                                    truncation=4,
                                    learn_non_evidence=True)),
}


@pytest.mark.parametrize("name", sorted(LEARN_GRAPHS))
def test_ext_learn_matches_tpu_kernel_interpret(name):
    """ItemGridEngine.learn(ext_pot=E, ext_pot_evid=E2) (plain path) ==
    PallasItemGridEngine(interpret=True).learn(..., return_state=True):
    weights and both chains, tolerance 0."""
    build, lpk = LEARN_GRAPHS[name]
    cg = build()
    plan, reason = jig.plan_item_grid(cg, True)
    assert plan is not None, reason
    rng = np.random.default_rng(2)
    e1 = _dyadic(rng, (cg.n_vars, cg.kmax))
    e2 = _dyadic(rng, (cg.n_vars, cg.kmax))
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    sched = dataclasses.replace(schedule_from_jax_plan(cg, plan),
                                arg_rank=np.asarray(plan.perm, np.int64))
    eng = pig.ItemGridEngine(pcg, device="cpu", schedule=sched)
    args = dict(seed=5, burn=2, epochs=3, stepsize=0.1, decay=1.0)
    w, x, xe = eng.learn(**args, lp=LearnParams(**lpk), ext_pot=e1,
                         ext_pot_evid=e2)
    w_ref, x_ref, xe_ref = jig.PallasItemGridEngine(cg, interpret=True).learn(
        **args, lp=JaxLearnParams(**lpk), ext_pot=e1, ext_pot_evid=e2,
        return_state=True)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(xe.numpy(), xe_ref)
    w0, _, _ = eng.learn(**args, lp=LearnParams(**lpk))
    assert not torch.equal(w0, w), "the potentials must change the weights"


def test_ext_without_evid_table_feeds_both_chains():
    """learn(ext_pot=E) with no ext_pot_evid gives the clamped chain E too
    (GibbsEngine's rule), the same as passing E twice."""
    cg = _coin_learn_graph()
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, device="cpu")
    e = _dyadic(np.random.default_rng(3), (cg.n_vars, cg.kmax))
    a = eng.learn(1, 1, 3, 0.1, ext_pot=e)
    b = eng.learn(1, 1, 3, 0.1, ext_pot=e, ext_pot_evid=e)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_ext_wrapper_checks_the_table():
    """A table of the wrong height is refused before any launch."""
    cg = _coin_graph()
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, device="cpu")
    with pytest.raises(ValueError, match="external potentials"):
        eng.run(1, 0, 1, ext_pot=np.zeros((cg.n_vars - 1, 2), np.float32))
    t = eng.tables
    with pytest.raises(ValueError, match="ext has shape"):
        pig._ext_ptr("ext", torch.zeros(cg.n_vars), t.device, cg.n_vars)


# ---- boundary messages -----------------------------------------------------

@pytest.mark.parametrize("dyadic", [True, False])
def test_messages_match_jax_and_golden(dyadic):
    """The port's messages (BSPEngine.messages and
    BSPItemGridInference._messages) == the JAX package's and == the
    golden potential restricted to factors owned by other parts (the
    contract of tests/test_bsp.py:53-73). Tolerance 0 with dyadic
    weights; 1e-5 otherwise, where a target with several terms may sum
    in another order than JAX's segment_sum."""
    w, v, f, fm = _random_graph(seed=7, categorical=True)
    if dyadic:
        w["initialValue"] = [0.5, -0.75, 0.25, 1.0]
    part = np.arange(len(v)) % 3
    tol = 0.0 if dyadic else 1e-5
    je = jbsp.BSPEngine(w, v, f, fm, part, mode="messages")
    want = np.asarray(je.messages(je.init_states()))
    pe = bsp.BSPEngine(w, v, f, fm, part, mode="messages", device="cpu")
    got = pe.messages(pe.init_states()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ji = jbsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                   interpret=True)
    pi = bsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                  device="cpu")
    got_i = pi._messages(pi.state.values).numpy()
    np.testing.assert_allclose(got_i, ji._messages(ji._values), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got_i, got)

    owner = bsp.factor_owner(f, fm, part)
    wv = w["initialValue"]
    var_value = v["initialValue"].astype(np.int64)
    for vid in range(len(v)):
        others = np.flatnonzero(owner != part[vid])
        for k in range(int(v["cardinality"][vid])):
            total = golden.potential(v, f, fm, wv, vid, k, var_value)
            local = golden.potential(v, f, fm, wv, vid, k, var_value,
                                     factors_to_skip=others)
            assert got[vid, k] == pytest.approx(total - local, abs=1e-5)


# ---- BSPItemGridInference end to end -----------------------------------------

def _coin_pairs(evidence):
    if evidence:
        w, v, f, fm, dm, _ = coin_model(40, 0.8, -0.5, 0.4, evidence=True,
                                        weight_init=(0.0, 0.0, 0.0),
                                        fixed=False, seed=3)
    else:
        w, v, f, fm, dm, _ = coin_model(40, 0.5, -0.25, 0.5, evidence=False,
                                        weight_init=(0.5, -0.25, 0.5),
                                        fixed=True)
    # every pair factor straddles the partition (tests/test_bsp.py:243)
    return w, v, f, fm, dm, (np.arange(len(v)) % 2).astype(np.int64)


@pytest.mark.parametrize("mode", ["values", "messages"])
def test_bsp_itemgrid_inference_matches_jax(mode):
    """BSPItemGridInference (CPU, plain kernels) == the JAX class
    (interpret-mode kernels): global values and tallies after 2 burn-in
    and 4 tallied syncs, tolerance 0."""
    w, v, f, fm, dm, part = _coin_pairs(False)
    je = jbsp.BSPItemGridInference(w, v, f, fm, part, mode=mode,
                                   domain_mask=dm, interpret=True)
    pe = bsp.BSPItemGridInference(w, v, f, fm, part, mode=mode,
                                  domain_mask=dm, device="cpu",
                                  schedules=_schedules(je))
    je.inference(seed=3, epochs=4, burn=2)
    got = pe.inference(seed=3, epochs=4, burn=2)
    np.testing.assert_array_equal(got.numpy(), je._values)
    np.testing.assert_array_equal(pe.state.counts.numpy(), je._counts)
    np.testing.assert_array_equal(pe.marginals(4), je.marginals(4))
    assert int(pe.state.counts.sum()) == 4 * len(v)


def test_bsp_itemgrid_learning_matches_jax():
    """Messages-mode learning, 1 burn-in sync and 3 epochs: weights and
    both chains == the JAX class's, tolerance 0 (one message term per
    target, so exact with learned weights)."""
    w, v, f, fm, dm, part = _coin_pairs(True)
    je = jbsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                   domain_mask=dm, interpret=True)
    pe = bsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                  domain_mask=dm, device="cpu",
                                  schedules=_schedules(je, learn=True))
    args = dict(seed=5, epochs=3, stepsize=0.15, decay=0.98, burn=1)
    w_ref = je.learn(**args, lp=JaxLearnParams(regularization=2,
                                                reg_param=1e-4))
    got = pe.learn(**args, lp=LearnParams(regularization=2, reg_param=1e-4))
    np.testing.assert_array_equal(got.numpy(), w_ref)
    np.testing.assert_array_equal(pe.state.values.numpy(), je._values)
    np.testing.assert_array_equal(pe.state.values_evid.numpy(),
                                  je._values_evid)
    assert not np.array_equal(w_ref, np.zeros(3, np.float32))


def test_bsp_itemgrid_state_carried_across():
    """A JAX run continued in the port (convert.bsp_state_from_reference)
    equals the JAX run continued in JAX: 1 learning epoch in JAX, then 3
    messages-mode inference syncs each side (the messages read the
    learned weights)."""
    w, v, f, fm, dm, part = _coin_pairs(True)
    je = jbsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                   domain_mask=dm, interpret=True)
    je.learn(seed=8, epochs=1, stepsize=0.2)
    pe = bsp.BSPItemGridInference(w, v, f, fm, part, mode="messages",
                                  domain_mask=dm, device="cpu",
                                  schedules=_schedules(je, learn=True))
    pe.state = bsp_state_from_reference(je._values, je._values_evid,
                                        je._weights, je._counts, "cpu")
    for eng in (je, pe):
        eng.inference(seed=10, epochs=3)
    np.testing.assert_array_equal(pe.state.weights.numpy(), je._weights)
    np.testing.assert_array_equal(pe.state.values.numpy(), je._values)
    np.testing.assert_array_equal(pe.state.counts.numpy(), je._counts)


def test_bsp_itemgrid_values_mode_refuses_learning():
    w, v, f, fm, dm, part = _coin_pairs(True)
    pe = bsp.BSPItemGridInference(w, v, f, fm, part, mode="values",
                                  domain_mask=dm, device="cpu")
    with pytest.raises(ValueError, match="requires messages mode"):
        pe.learn(seed=0, epochs=1, stepsize=0.1)
    with pytest.raises(ValueError, match="mode"):
        bsp.BSPItemGridInference(w, v, f, fm, part, mode="halo",
                                 device="cpu")


def test_bsp_engines_default_to_the_card():
    """BSPItemGridInference, BSPEngine and their part engines run on
    ``cuda`` unless the caller asks for the CPU."""
    from numbskull_tpu_torch.ops.gibbs import GibbsEngine
    for cls in (bsp.BSPItemGridInference, bsp.BSPEngine, GibbsEngine):
        assert inspect.signature(cls).parameters["device"].default == \
            "cuda"
    if not torch.cuda.is_available():
        w, v, f, fm, dm, part = _coin_pairs(False)
        with pytest.raises((RuntimeError, AssertionError)):
            bsp.BSPItemGridInference(w, v, f, fm, part)


# ---- BSPEngine on the tensor-op GibbsEngine (statistical) --------------------

def _replicate(w, v, f, fm, copies):
    """``copies`` disjoint copies of a graph sharing its weights: every
    copy has the one copy's exact marginals, and their mean has a
    fraction of one chain's Monte-Carlo error."""
    n, F, E = len(v), len(f), len(fm)
    v2, f2, fm2 = np.tile(v, copies), np.tile(f, copies), np.tile(fm, copies)
    f2["ftv_offset"] += np.repeat(np.arange(copies) * E, F).astype(
        f2["ftv_offset"].dtype)
    fm2["vid"] += np.repeat(np.arange(copies) * n, E).astype(
        fm2["vid"].dtype)
    return w, v2, f2, fm2


@pytest.mark.parametrize("mode", ["values", "messages"])
def test_bsp_engine_marginals_match_exact(mode):
    """Partitioned marginals vs the exact joint of a boolean graph (the
    graph of tests/test_bsp.py:88-104, in 60 disjoint copies split the
    same way): each variable's mean over the copies within 0.06 (the JAX
    test's tolerance for one copy over 3000 epochs)."""
    w, v, f, fm = _random_graph(seed=11, n_vars=9, n_factors=14)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    copies = 60
    part = np.tile(np.arange(len(v)) % 3, copies)
    eng = bsp.BSPEngine(*_replicate(w, v, f, fm, copies), part, mode=mode,
                        device="cpu")
    epochs = 250
    states = eng.inference(eng.init_states(),
                           torch.Generator().manual_seed(1), epochs=epochs,
                           burn=30, sync_every=10)
    marg = eng.marginals(states, epochs).reshape(copies, len(v), -1)
    assert np.abs(marg.mean(0)[:, :2] - exact[:, :2]).max() < 0.06


@pytest.mark.parametrize("mode", ["values", "messages"])
def test_bsp_engine_learning_recovers_coin_weights(mode):
    """Distributed SGD (per-part deltas summed) recovers the coin weights
    within 0.2 with every (x1, x2) pair split across the two parts
    (tests/test_bsp.py:107-126)."""
    a, b, c = 0.8, -0.5, 0.4
    w, v, f, fm, dm, _ = coin_model(1000, a, b, c, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    part = np.arange(len(v)) % 2
    eng = bsp.BSPEngine(w, v, f, fm, part, mode=mode, domain_mask=dm,
                        device="cpu")
    states = eng.learn(eng.init_states(), torch.Generator().manual_seed(0),
                       epochs=100, stepsize=0.1, decay=0.99, burn=5,
                       lp=LearnParams(regularization=2, reg_param=1e-4))
    got = eng.weights(states)
    assert np.abs(got - [a, b, c]).max() < 0.2


def test_bsp_engine_leaves_evidence_and_ghosts():
    """Without sample_evidence, evidence keeps its value; a part's sweep
    never changes a variable it does not own; after the exchange every
    part holds the owners' values."""
    w, v, f, fm = _random_graph(seed=5, n_vars=12, n_factors=20)
    v["isEvidence"][:4] = 1
    part = np.arange(len(v)) % 2
    eng = bsp.BSPEngine(w, v, f, fm, part, mode="values", device="cpu")
    states = eng.init_states()
    gen = torch.Generator().manual_seed(4)
    for _ in range(5):
        for p, e in enumerate(eng.engines):
            before = states[p].var_value.clone()
            after = e.inference(states[p], eng._seed(gen), epochs=1,
                                sample_evidence=False).var_value
            ghost = torch.as_tensor(~eng.owned_masks[p])
            assert torch.equal(after[ghost], before[ghost])
        states = eng.inference(states, gen, epochs=2,
                               sample_evidence=False)
        for s in states:
            assert torch.equal(s.var_value, states[0].var_value)
            np.testing.assert_array_equal(
                s.var_value[:4].numpy(), v["initialValue"][:4])


def test_sync_traffic_matches_jax():
    w, v, f, fm = _random_graph(seed=2)
    part = np.arange(len(v)) % 2
    for mode in ("values", "messages"):
        got = bsp.BSPEngine(w, v, f, fm, part, mode=mode,
                            device="cpu").sync_traffic()
        want = jbsp.BSPEngine(w, v, f, fm, part, mode=mode).sync_traffic()
        assert got == want


def test_choose_partition_matches_jax():
    """partition.choose_partition (a copy of the JAX module) gives the
    same partition and report on a random graph."""
    w, v, f, fm = _random_graph(seed=9, n_vars=300, n_factors=500)
    edges = conflict_edges(v, f, fm)
    np.testing.assert_array_equal(edges, jax_conflict_edges(v, f, fm))
    for n_parts in (2, 3, 4):
        got, rep = partition.choose_partition(len(v), edges, n_parts)
        want, rep_j = jpart.choose_partition(len(v), edges, n_parts)
        np.testing.assert_array_equal(got, want)
        assert rep == rep_j


def test_partition_module_is_a_copy():
    """parallel/partition.py differs from the JAX module only in its
    import lines."""
    here = os.path.dirname(os.path.abspath(__file__))
    read = [open(os.path.join(here, "..", pkg, "parallel", "partition.py"))
            .read().splitlines() for pkg in ("numbskull_tpu",
                                             "numbskull_tpu_torch")]
    diff = [(a, b) for a, b in zip(*read) if a != b]
    assert len(read[0]) == len(read[1])
    assert diff and all(a.replace("numbskull_tpu.", "numbskull_tpu_torch.")
                        == b and "import" in a for a, b in diff)


# ---- the CLI's --parts -----------------------------------------------------------

def _weights(path):
    rows = np.loadtxt(os.path.join(path, "inference_result.out.weights.text"),
                      ndmin=2)
    return rows[:, 1]


def test_cli_parts_matches_jax_cli(tmp_path):
    """--parts 2 --device cpu on the coin fixture writes both files; the
    learned weight is within 0.25 of the JAX CLI's --parts 2 on the same
    files, and the marginals are probabilities of every variable."""
    src = coin_fixture(str(tmp_path / "coin"))
    args = [src, "--parts", "2", "-l", "60", "-i", "100", "-b", "10", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    ns = port_cli.main(args + ["-o", out_p, "--device", "cpu"])
    jax_cli.main(args + ["-o", out_j])
    assert ns.distributed["n_parts"] == 2
    assert ns.distributed["mode"] == "values"
    w_p, w_j = _weights(out_p), _weights(out_j)
    assert w_p.shape == (1,) and abs(w_p[0] - w_j[0]) < 0.25
    rows = np.loadtxt(os.path.join(out_p, "inference_result.out.text"),
                      ndmin=2)
    assert rows.shape == (18, 3)
    assert ((rows[:, 2] >= 0) & (rows[:, 2] <= 1)).all()


def test_cli_parts_on_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    src = coin_fixture(str(tmp_path / "coin"))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_cli.main([src, "--parts", "2", "-i", "10", "-q", "-o",
                       str(tmp_path / "o"), "--device", "cuda"])
    assert not os.path.exists(str(tmp_path / "o"))


def test_coin_marginals_through_bsp_itemgrid():
    """BSPItemGridInference on 100 coin pairs split across two parts:
    marginal means within 0.03 of the exact joint in both modes."""
    a, b, c = 0.3, -0.2, 0.4
    w, v, f, fm, dm, _ = coin_model(100, a, b, c, evidence=False,
                                    weight_init=(a, b, c), fixed=True)
    part = np.arange(len(v)) % 2
    ex = coin_exact_marginal(a, b, c)
    for mode in ("values", "messages"):
        eng = bsp.BSPItemGridInference(w, v, f, fm, part, mode=mode,
                                       domain_mask=dm, device="cpu")
        eng.inference(seed=0, epochs=300, burn=30, sync_every=10)
        m = eng.marginals(300)
        assert abs(m[0::2, 1].mean() - (ex[2] + ex[3])) < 0.03
        assert abs(m[1::2, 1].mean() - (ex[1] + ex[3])) < 0.03
