"""The port's learning path against the TPU learn kernel, on the CPU.

The JAX package's ``_make_learn_kernel`` runs here in interpret mode with
its software PRNG (``PallasItemGridEngine(cg, interpret=True).learn``);
the port's ``ItemGridEngine.learn`` runs its plain PyTorch version (CPU
tensors) under a schedule derived from the JAX plan: the same colors and
draw positions, and each row's items in the kernel's slot order
(``arg_rank`` = the plan's ``perm``). Every per-weight gradient sum of
these fixtures is a sum of integers (featureValue 1, factor values in
{-1, 0, 1}), exact in any order, so weights, free chain and clamped
chain must agree with tolerance 0.
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from numbskull_tpu import types as JT
from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import (coin_model, ising_grid, lf_model,
                                  voting_grouped)
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops.gibbs import LearnParams as JaxLearnParams
from numbskull_tpu_torch.compile import compile_graph as port_compile_graph
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.models import ising_grid as port_ising_grid
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams
from test_torch_itemgrid import schedule_from_jax_plan


def learn_schedule_from_jax_plan(cg, plan) -> pig.Schedule:
    """The JAX learn kernel's sweep as a port Schedule: the colors and
    draw positions of ``schedule_from_jax_plan``, every step `row` /
    `cdf`, and items summed in the kernel's slot order."""
    s = schedule_from_jax_plan(cg, plan)
    n = len(s.colors)
    return dataclasses.replace(s, maps=("row",) * n, draws=("cdf",) * n,
                               arg_rank=np.asarray(plan.perm, np.int64))


def _port_engine(cg):
    plan, reason = jig.plan_item_grid(cg, True)
    assert plan is not None, reason
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, sample_evidence=True, device="cpu",
                             schedule=learn_schedule_from_jax_plan(cg,
                                                                   plan))
    return eng, plan


# ---- fixtures (JAX models, numpy seeds) ---------------------------------

def _coin():
    w, v, f, fm, dm, _ = coin_model(300, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _ising16():
    w, v, f, fm, dm, _ = ising_grid(16, 16, weight=0.25, fixed=False)
    rng = np.random.default_rng(1)
    v["isEvidence"] = (rng.random(len(v)) < 0.3).astype(np.int8)
    v["initialValue"] = rng.integers(0, 2, len(v))
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _lf_card3():
    w, v, f, fm, dm, _ = lf_model(0.5, [0.5, 0.25, 0.75], copies=100,
                                  seed=1)
    w["isFixed"][2] = True
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _voting10():
    w, v, f, fm, dm, _ = voting_grouped(500, 10, weight=0.5, fixed=False,
                                        evidence_frac=0.3)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _istrue2048():
    n = 2048
    rng = np.random.default_rng(9)
    v = JT.new_variables(n)
    v["isEvidence"] = 1
    v["initialValue"] = rng.integers(0, 2, n)
    v["dataType"] = 0
    v["cardinality"] = 2
    w = JT.new_weights(n)
    w["isFixed"] = False
    w["initialValue"] = 0.0
    f = JT.new_factors(n)
    f["factorFunction"] = JT.FUNC_ISTRUE
    f["weightId"] = np.arange(n)
    f["featureValue"] = 1.0
    f["arity"] = 1
    f["ftv_offset"] = np.arange(n)
    fm = JT.new_fmap(n)
    fm["vid"] = np.arange(n)
    return jax_compile_graph(w, v, f, fm)


FIXTURES = {
    # name: (graph, learn params, seed, burn, epochs, stepsize, decay)
    "coin_l2": (_coin, dict(regularization=2, reg_param=1e-4), 5, 3, 8,
                0.1, 1.0),
    "ising16_sum": (_ising16, dict(regularization=0, grad_agg="sum"), 2, 2,
                    6, 0.01, 1.0),
    "lf_card3_l1": (_lf_card3, dict(regularization=1, reg_param=0.01,
                                    truncation=4, learn_non_evidence=True),
                    3, 2, 8, 0.05, 1.0),
    "voting10": (_voting10, dict(), 4, 1, 5, 0.05, 1.0),
    "istrue2048_l1": (_istrue2048, dict(regularization=1, reg_param=0.01,
                                        truncation=3), 1, 1, 6, 0.4, 1.0),
    "coin_l2_decay": (_coin, dict(regularization=2, reg_param=1e-4), 6, 2,
                      8, 0.1, 0.99),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_learn_matches_tpu_kernel_interpret(name):
    """ItemGridEngine.learn (plain path) == PallasItemGridEngine
    (interpret=True).learn(return_state=True): weights, free chain and
    clamped chain, tolerance 0 (the decay case included: over its 8
    epochs torch's and XLA's float32 exp and log give the same step
    sizes; see test_learn_step_constants_match_xla)."""
    build, lpk, seed, burn, epochs, step, decay = FIXTURES[name]
    cg = build()
    eng, plan = _port_engine(cg)
    w, x, xe = eng.learn(seed, burn, epochs, step, decay, LearnParams(**lpk))
    w_ref, x_ref, xe_ref = jig.PallasItemGridEngine(cg, interpret=True).learn(
        seed=seed, burn=burn, epochs=epochs, stepsize=step, decay=decay,
        lp=JaxLearnParams(**lpk), return_state=True)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(xe.numpy(), xe_ref)
    assert not np.array_equal(w_ref, np.asarray(cg.weight_init)), \
        "the weights must move"
    if name == "coin_l2":
        assert (plan.cmeta[:, 5] == 1).any()     # affine learn colors
    if name == "voting10":
        assert plan.A > 8                         # the rolled slot loop
    if name == "lf_card3_l1":
        assert w.numpy()[2] == np.float32(cg.weight_init[2])   # fixed


def test_learn_step_constants_match_xla():
    """The per-epoch step size step0 * exp(f32(i) * log(decay)) in torch
    float32 against XLA's. torch's and XLA's float32 log and exp are
    different approximations, each one ulp apart from the other on some
    inputs (about a fifth of decays for log, a tenth of arguments for
    exp), and the factor i carries log's ulp into the exponent. So the
    stated tolerance is a relative 2**-22 * (2 + |i * ln(decay)|); the
    step agrees to the bit on most epochs (decay 1 always). Given the
    same step, the L2 shrink 1 / (1 + reg * step) is equal to the bit
    (with the fma XLA contracts it into)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step_of(step0, decay, i):
        return step0 * jnp.exp(i.astype(jnp.float32) * jnp.log(decay))

    @jax.jit
    def shrink_of(step, reg):
        return 1.0 / (1.0 + reg * step)

    n_equal = n_all = 0
    for step0, decay in ((0.1, 0.99), (0.05, 0.95), (0.4, 0.98),
                         (0.05, 0.01 ** (1.0 / 200)), (0.1, 1.0)):
        for i in (0, 1, 7, 63, 149, 1000):
            s = np.float32(step_of(jnp.float32(step0), jnp.float32(decay),
                                   jnp.int32(i)))
            got = np.float32(pig.learn_step_of(LearnParams(), step0, decay,
                                               i).step)
            tol = 2.0 ** -22 * (2 + abs(i * np.log(decay)))
            assert abs(float(got) - float(s)) <= tol * float(s), \
                (step0, decay, i, got, s)
            if decay == 1.0:
                assert got == s
            n_equal += int(got == s)
            n_all += 1
            reg = torch.tensor(1e-4, dtype=torch.float32)
            sh = torch.tensor(1.0) / pig.fma32(reg, float(s), 1.0)
            assert np.float32(sh) == np.float32(
                shrink_of(s, jnp.float32(1e-4))), (step0, decay, i)
    assert n_equal >= n_all * 2 // 3


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational ``q`` (ties to even)."""
    f = np.float32(float(q))
    best = f
    for g in (np.nextafter(f, np.float32(-np.inf)),
              np.nextafter(f, np.float32(np.inf))):
        dg, db = abs(Fraction(float(g)) - q), abs(Fraction(float(best)) - q)
        if dg < db or (dg == db and
                       np.float32(g).view(np.int32) % 2 == 0):
            best = g
    return np.float32(best)


def test_fma32_is_correctly_rounded():
    """fma32 against exact rational arithmetic, on random triples and on
    ones whose exact result sits next to a float32 rounding midpoint
    (where rounding through float64 twice would go wrong)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    # c = -(a*b rounded to f32) plus a tiny part: result ~ the product's
    # rounding error, a near-midpoint case for the float64 detour
    c[:100] = -(a[:100] * b[:100]).astype(np.float32)
    one = np.float32(1.0)
    eps = np.float32(2.0 ** -24)
    a[100:110], b[100:110] = one + eps * 2, one + eps * 2
    c[100:110] = np.float32(2.0 ** -60) * np.arange(1, 11)
    got = pig.fma32(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) +
                                Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_weight_sums_follow_the_kernel_order():
    """_weight_sums (the plain version of the reduce and update
    kernels' order) against a sequential float32 replay of that order,
    on non-dyadic gradients over 3 weights and more than one chunk."""
    w, v, f, fm, dm, _ = coin_model(1500, evidence=True, seed=4)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    eng = pig.ItemGridEngine(cg, device="cpu")
    lt = eng.learn_tables()
    rng = np.random.default_rng(2)
    for ci in range(lt.sweep.n_steps):
        lo = lt.sweep.item0[ci]
        n_items = len(lt.sweep.item_index[ci])
        g = rng.standard_normal(n_items).astype(np.float32) / 3
        inc = rng.integers(0, 2, n_items).astype(np.int32)
        gs, ns = pig._weight_sums(lt, ci, torch.as_tensor(g),
                                  torch.as_tensor(inc))
        h = lt.host
        a, m = lt.wt0[ci], lt.n_wt[ci]
        assert m > 0 and h["wt_nch"][a:a + m].max() > 1
        for q in range(m):
            total, count = None, 0
            for c in range(h["wt_ch0"][a + q],
                           h["wt_ch0"][a + q] + h["wt_nch"][a + q]):
                s, ln = h["ch_start"][c], h["ch_len"][c]
                vals = np.zeros(pig.RED_CHUNK, np.float32)
                ids = h["red_item"][s:s + ln] - lo
                vals[:ln] = g[ids]
                count += int(inc[ids].sum())
                lanes = np.zeros(32, np.float32)
                for j in range(32):
                    lanes = (lanes + vals[j * 32:(j + 1) * 32]).astype(
                        np.float32)
                hh = 16
                while hh:
                    lanes = (lanes[:hh] + lanes[hh:2 * hh]).astype(np.float32)
                    hh //= 2
                total = lanes[0] if total is None else \
                    np.float32(total + lanes[0])
            assert gs[q].item() == total and ns[q].item() == count


def test_learn_tables_cover_every_item_once():
    cg = compiled_graph_from_reference(dataclasses.asdict(_voting10()))
    lt = pig.ItemGridEngine(cg, device="cpu").learn_tables()
    t, h = lt.sweep, lt.host
    assert set(t.map_codes) == {pig.MAPS.index("row")}
    assert set(t.draw_codes) == {pig.DRAWS.index("cdf")}
    n_items = t.item0[-1] + len(t.item_index[-1])
    assert sorted(h["red_item"]) == list(range(n_items))
    wid = t.it_wid.numpy()
    for ci in range(t.n_steps):
        for c in range(lt.ch0[ci], lt.ch0[ci] + lt.n_ch[ci]):
            s, ln = h["ch_start"][c], h["ch_len"][c]
            assert 0 < ln <= pig.RED_CHUNK
            assert len(set(wid[h["red_item"][s:s + ln]])) == 1
    assert lt.it_fv.dtype == torch.float32 and len(lt.it_fv) == n_items


def test_max_colors_marks_conflicting_steps():
    """compile with max_colors=1 puts neighbours in one color: the step
    is marked, and its plain learn and sweep steps read every value from
    before the step (a step on a copy that is overwritten as it runs
    gives the same result)."""
    w, v, f, fm, dm, _ = port_ising_grid(6, 6, weight=0.25, fixed=False)
    v["isEvidence"][::3] = 1
    one = port_compile_graph(w, v, f, fm, domain_mask=dm, max_colors=1)
    free = port_compile_graph(w, v, f, fm, domain_mask=dm)
    e1 = pig.ItemGridEngine(one, device="cpu")
    assert one.n_colors == 1 and e1.tables.conflict == [True]
    assert not any(pig.ItemGridEngine(free, device="cpu").tables.conflict)

    x0 = torch.as_tensor(one.var_init, dtype=torch.int32)
    w0 = torch.as_tensor(one.weight_init, dtype=torch.float32)
    counts = torch.zeros((one.n_vars, one.kmax), dtype=torch.int32)
    x = x0.clone()
    pig.color_step_reference(e1.tables, 0, x, counts, w0, 3, 0, True)
    # the draw of every row from the step's start values alone
    t = e1.tables
    pot = pig._padded_potentials(t, 0, x0, w0)
    u = pig.block_uniforms(3, pig.salt16_of(0, 0), t.row_upos, False)
    new = pig.draw_sigmoid2(pot[:, 0], pot[:, 1], u)
    upd = (t.row_flags & pig.ROW_UPDATE) != 0
    want = x0.clone()
    want[t.row_vid.long()] = torch.where(upd, new, x0[t.row_vid.long()])
    assert torch.equal(x, want)

    lt = e1.learn_tables()
    hs = pig.learn_step_of(LearnParams(), 0.1, 1.0, 0)
    xa, xea, wa = x0.clone(), x0.clone(), w0.clone()
    pig.learn_color_step_reference(lt, 0, xa, xea, wa, 5, 1 << 16, hs)
    assert not torch.equal(wa, w0)
    # the same step twice from the same state gives the same result
    xb, xeb, wb = x0.clone(), x0.clone(), w0.clone()
    pig.learn_color(lt, 0, xb, xeb, wb, 5, 1 << 16, hs)
    assert torch.equal(xa, xb) and torch.equal(xea, xeb) and \
        torch.equal(wa, wb)


def test_learn_wrapper_devices_and_launch_counts():
    cg = compiled_graph_from_reference(dataclasses.asdict(_coin()))
    eng = pig.ItemGridEngine(cg, device="cpu")
    lt = eng.learn_tables()
    assert lt.ptrs == {}                 # not built for the kernel
    hs = pig.learn_step_of(LearnParams(), 0.1, 1.0, 0)
    x = torch.zeros(cg.n_vars, dtype=torch.int32, device="meta")
    w = torch.zeros(cg.n_weights, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pig.learn_color(lt, 0, x, x, w, 0, 0, hs)
    xc = torch.as_tensor(cg.var_init, dtype=torch.int32)
    wc = torch.as_tensor(cg.weight_init, dtype=torch.float32)
    with pytest.raises(ValueError, match="not built for the kernel"):
        pig._launch_learn(lt, 0, xc, xc.clone(), wc, 0, 0, hs)
    with pytest.raises(ValueError, match="shape"):
        pig._launch_learn(lt, 0, xc[:-1], xc, wc, 0, 0, hs)
    with pytest.raises(ValueError, match="sample_evidence"):
        pig.ItemGridEngine(cg, sample_evidence=False, device="cpu").learn(
            0, 1, 1, 0.1)
    with pytest.raises(ValueError, match="block bits"):
        pig.sweep_color(eng.tables, 0, xc, xc, wc, 0, 0, False,
                        pig.CLAMPED_SALT_XOR)
    eng.learn(1, 1, 2, 0.1)
    assert pig.LEARN_LAUNCHES == 0 and pig.KERNEL_LAUNCHES == 0
