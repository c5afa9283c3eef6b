"""The port's tensor-op GibbsEngine and its draw, on the CPU.

Its uniforms come from a torch generator, the JAX engine's from
threefry keys, so the two are held together statistically: the draw
against the softmax it samples, marginals against closed forms and the
JAX GibbsEngine, learning against the weights that generated the
evidence (tests/test_gibbs.py and tests/test_learning.py). The rest is
exact: which variables a sweep may change, the external potentials'
rules and the state handling.
"""

import numpy as np
import pytest
import torch

import jax

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import lf_model as jax_lf_model
from numbskull_tpu.ops.gibbs import GibbsEngine as JaxGibbsEngine
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import (coin_exact_marginal, coin_model,
                                        lf_model)
from numbskull_tpu_torch.ops.gibbs import GibbsEngine, LearnParams
from numbskull_tpu_torch.ops.sample import draw, make_generator

from _torch_threads import cap_threads

cap_threads()


def test_draw_matches_softmax():
    """Frequencies of 40,000 draws per row type within 0.01 of the
    masked softmax; no value at or above the row's cardinality."""
    pot = torch.tensor([[0.3, -0.2, 1.0, 0.5],
                        [2.0, 0.0, 9.0, 9.0],
                        [-1.0, 0.5, 0.25, -3.0]], dtype=torch.float32)
    card = torch.tensor([4, 2, 3])
    n = 40000
    vals = draw(pot.repeat(n, 1), card.repeat(n), make_generator(3, "cpu"))
    vals = vals.view(n, 3)
    for r in range(3):
        c = int(card[r])
        p = torch.softmax(pot[r, :c].double(), 0).numpy()
        freq = np.bincount(vals[:, r].numpy(), minlength=4) / n
        assert (freq[c:] == 0).all()
        np.testing.assert_allclose(freq[:c], p, atol=0.01)


def _coin(copies, a, b, c):
    w, v, f, fm, dm, _ = coin_model(copies, evidence=False,
                                    weight_init=(a, b, c), fixed=True)
    return compile_graph(w, v, f, fm, domain_mask=dm)


def test_gibbs_engine_coin_marginals():
    """Coin marginals within 0.02 of the exact joint."""
    a, b, c = 0.3, -0.2, 0.4
    eng = GibbsEngine(_coin(200, a, b, c), device="cpu")
    st = eng.inference(eng.init_state(), 1, epochs=400, burn=30)
    m = eng.marginals(st, 400)
    ex = coin_exact_marginal(a, b, c)
    assert abs(m[0::2, 1].mean() - (ex[2] + ex[3])) < 0.02
    assert abs(m[1::2, 1].mean() - (ex[1] + ex[3])) < 0.02
    assert int(st.count.sum()) == 400 * 400


def test_gibbs_engine_matches_jax_engine_on_lf():
    """A categorical LF graph (cardinality 3): marginals within 0.03 of
    the JAX GibbsEngine's on the same compiled graph."""
    args = (0.6, [0.7, 0.4, 0.8])
    w, v, f, fm, dm, _ = lf_model(*args, copies=150, seed=2)
    w["isFixed"] = True
    w["initialValue"] = [0.4, 0.6, 0.3, 0.9]
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    st = eng.inference(eng.init_state(), 2, epochs=400, burn=20)
    got = eng.marginals(st, 400)
    wj, vj, fj, fmj, dmj, _ = jax_lf_model(*args, copies=150, seed=2)
    wj["isFixed"] = True
    wj["initialValue"] = [0.4, 0.6, 0.3, 0.9]
    je = JaxGibbsEngine(jax_compile_graph(wj, vj, fj, fmj, domain_mask=dmj))
    sj = je.inference(je.init_state(), jax.random.PRNGKey(2), epochs=2000,
                      burn=20)
    want = je.marginals(sj, 2000)
    card = np.asarray(eng.cg.var_card)
    for k in range(3):
        rows = card > k
        assert abs(got[rows, k].mean() - want[rows, k].mean()) < 0.03


@pytest.mark.parametrize("lp", [
    LearnParams(regularization=2, reg_param=1e-4),
    LearnParams(regularization=1, reg_param=1e-4, truncation=2),
    LearnParams(regularization=0, grad_agg="sum")])
def test_gibbs_engine_learning_recovers_coin_weights(lp):
    """Dual-chain SGD on a coin graph with evidence drawn from (0.8,
    -0.5, 0.4): weights within 0.2, for L2, L1 and the summed
    gradient."""
    truth = (0.8, -0.5, 0.4)
    w, v, f, fm, dm, _ = coin_model(1000, *truth, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    step = 0.1 if lp.grad_agg == "mean" else 0.0005
    st = eng.learn(eng.init_state(), 0, epochs=100, stepsize=step,
                   decay=0.99, burn=5, lp=lp)
    got = st.weight_value.numpy()
    assert np.abs(got - truth).max() < 0.2, got


def _istrue_graph(n, weight, evidence=0):
    """n isolated variables with one ISTRUE factor each on weight 0; the
    first ``evidence`` are evidence at 1."""
    v = T.new_variables(n)
    v["isEvidence"][:evidence] = 1
    v["initialValue"][:evidence] = 1
    v["cardinality"] = 2
    w = T.new_weights(1)
    w["initialValue"] = weight
    w["isFixed"] = True
    f = T.new_factors(n)
    f["factorFunction"] = T.FUNC_ISTRUE
    f["weightId"] = 0
    f["featureValue"] = 1.0
    f["arity"] = 1
    f["ftv_offset"] = np.arange(n)
    fm = T.new_fmap(n)
    fm["vid"] = np.arange(n)
    return compile_graph(w, v, f, fm)


def test_gibbs_engine_external_potentials():
    """ext_pot adds to each variable's conditional: P(x = 1) =
    sigmoid((w + e1) - (-w + e0)) for an isolated ISTRUE variable
    (within 0.01 over 4000 variables and 100 epochs); a wider table's
    extra columns are ignored."""
    n, wt = 4000, 0.25
    eng = GibbsEngine(_istrue_graph(n, wt), device="cpu")
    ext = np.zeros((n, 3), np.float32)
    ext[:, 0], ext[:, 1], ext[:, 2] = 0.5, -0.25, 7.0
    st = eng.inference(eng.init_state(), 4, epochs=100, ext_pot=ext)
    p1 = eng.marginals(st, 100)[:, 1].mean()
    want = 1.0 / (1.0 + np.exp(-((wt - 0.25) - (-wt + 0.5))))
    assert abs(p1 - want) < 0.01


def test_gibbs_engine_learn_ext_defaults_to_both_chains():
    """learn(ext_pot=E) without ext_pot_evid == learn(ext_pot=E,
    ext_pot_evid=E) from the same seed: the clamped chain
    takes E (numbskull_tpu/ops/gibbs.py:451-453)."""
    w, v, f, fm, dm, _ = coin_model(50, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    e = np.random.default_rng(0).normal(size=(len(v), 2)).astype(np.float32)
    outs = [eng.learn(eng.init_state(), 5, epochs=3, stepsize=0.1,
                      burn=1, ext_pot=e, **kw)
            for kw in ({}, {"ext_pot_evid": e})]
    for name in ("var_value", "var_value_evid", "weight_value"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name))


def test_gibbs_engine_leaves_evidence_and_frozen_rows():
    """Without sample_evidence, evidence keeps its value and is not
    tallied; frozen variables (isEvidence=4, a partition's ghosts) never
    change in inference or learning; the clamped chain pins evidence;
    the state passed in is not changed."""
    n = 600
    w, v, f, fm, dm, _ = coin_model(n // 2, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.1, 0.1, 0.1),
                                    fixed=False, seed=3)
    frozen = np.arange(n) % 5 == 0
    v["isEvidence"][np.arange(n) % 5 < 3] = 0
    v["isEvidence"][frozen] = 4
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device="cpu")
    ev = torch.as_tensor(v["isEvidence"] == 1)
    fz = torch.as_tensor(frozen)
    st0 = eng.init_state()
    keep = st0.var_value.clone()
    st = eng.inference(st0, 6, epochs=20, sample_evidence=False)
    assert torch.equal(st0.var_value, keep)
    assert torch.equal(st.var_value[ev | fz], keep[ev | fz])
    assert int(st.count[ev | fz].sum()) == 0
    assert not torch.equal(st.var_value, keep)
    st = eng.learn(st, 7, epochs=5, stepsize=0.1, burn=2)
    assert torch.equal(st.var_value[fz], keep[fz])
    assert torch.equal(st.var_value_evid[fz | ev], keep[fz | ev])
