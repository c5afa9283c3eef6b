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
from numbskull_tpu_torch.models import lf_model as port_lf_model
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


def _replay_lanes(vals: np.ndarray, width: int) -> np.float32:
    """A sequential float32 replay of one sum of the learn kernels: lane
    l adds vals[l], vals[l + width], ... in order from 0.0, then the
    lane sums halve pairwise (lane l adds lane l + h, h = width / 2, ...,
    1)."""
    lanes = np.zeros(width, np.float32)
    for j in range(0, len(vals), width):
        part = np.asarray(vals[j:j + width], np.float32)
        lanes[:len(part)] = lanes[:len(part)] + part
    h = width // 2
    while h:
        lanes = lanes[:h] + lanes[h:2 * h]
        h //= 2
    return lanes[0]


def _replay_weight_sums(o: dict, g: np.ndarray, inc: np.ndarray):
    """The documented order of one step, item by item from its local
    order tables ``o``: every piece of one weight over TILE_ROWS lanes in
    item order, every other piece per weight over WARP lanes in the
    order of its list, each into its slot; then each weight's slots in
    slot order over SUM_WIDTH lanes when it has more than SUM_WIDTH,
    otherwise WARP lanes."""
    n_g = len(o["gr_len"])
    part = np.zeros(n_g, np.float32)
    cnt = np.zeros(n_g, np.int64)
    ends = np.append(o["pc_g0"][1:], n_g)
    for k, (s, ln) in enumerate(zip(o["pc_start"], o["pc_len"])):
        groups = range(o["pc_g0"][k], ends[k])
        for q in groups:
            if len(groups) == 1:
                ids = s + np.arange(ln)
                width = pig.TILE_ROWS
            else:
                a = o["pc_perm"][k] + o["gr_off"][q]
                ids = s + o["perm"][a:a + o["gr_len"][q]]
                width = pig.WARP
            part[o["gr_slot"][q]] = _replay_lanes(g[ids], width)
            cnt[o["gr_slot"][q]] = inc[ids].sum()
    sums, counts = [], []
    for p0, n in zip(o["wt_p0"], o["wt_np"]):
        width = pig.SUM_WIDTH if n > pig.SUM_WIDTH else pig.WARP
        sums.append(_replay_lanes(part[p0:p0 + n], width))
        counts.append(int(cnt[p0:p0 + n].sum()))
    return np.asarray(sums, np.float32), np.asarray(counts)


@pytest.mark.parametrize("copies", [1500, 140000])
def test_weight_sums_follow_the_kernel_order(copies):
    """_weight_sums (the plain version of the step and sum kernels'
    order) against a sequential float32 replay of that order, on
    non-dyadic gradients: coin graphs (3 weights, every tile holding two
    of them, 12 tiles per weight and color at 1500 copies, 1094 at
    140,000, where each weight's sum takes a block of SUM_WIDTH lanes)."""
    w, v, f, fm, dm, _ = coin_model(copies, evidence=True, seed=4)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    lt = pig.ItemGridEngine(cg, device="cpu").learn_tables()
    rng = np.random.default_rng(2)
    for ci in range(lt.sweep.n_steps):
        o = lt.host[ci]
        n_items = len(lt.sweep.item_index[ci])
        assert lt.n_wt[ci] == 2 and (o["wt_np"] > 1).all()
        assert lt.n_big[ci] == (2 if copies > pig.SUM_WIDTH *
                                pig.TILE_ROWS else 0)
        assert (o["pc_perm"] >= 0).all()      # every tile: 2 weights
        g = rng.standard_normal(n_items).astype(np.float32) / 3
        inc = rng.integers(0, 2, n_items).astype(np.int32)
        gs, ns = pig._weight_sums(lt, ci, torch.as_tensor(g),
                                  torch.as_tensor(inc))
        want_g, want_n = _replay_weight_sums(o, g, inc)
        np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                      want_g.view(np.int32))
        np.testing.assert_array_equal(ns.numpy(), want_n)


def test_learn_tables_cover_every_item_once():
    """The order tables of the voting graph (one weight) and of the LF
    graph (several weights per tile): tiles cover each step's rows in
    order within the row and item budgets, every item lies in exactly
    one (piece, weight) group whose items all carry that weight, and the
    slots run weight-major with pieces in row order."""
    several = 0
    for model in (_voting10, _lf_card3):
        cg = compiled_graph_from_reference(dataclasses.asdict(model()))
        several += _check_order_tables(
            pig.ItemGridEngine(cg, device="cpu").learn_tables())
    assert several > 0


def _check_order_tables(lt) -> int:
    """test_learn_tables_cover_every_item_once on one graph's tables;
    returns the pieces that hold more than one weight."""
    t = lt.sweep
    assert set(t.map_codes) == {pig.MAPS.index("row")}
    assert set(t.draw_codes) == {pig.DRAWS.index("cdf")}
    n_items = t.item0[-1] + len(t.item_index[-1])
    assert lt.it_fv.dtype == torch.float32 and len(lt.it_fv) == n_items
    wid = t.it_wid.numpy()
    row_item = t.row_item.numpy()
    tl_r0 = lt.tl_r0.numpy()
    assert tl_r0[-1] == sum(t.n_rows)
    several = 0
    for ci in range(t.n_steps):
        o, lo = lt.host[ci], t.item0[ci]
        rows = np.append(o["tl_r0"], t.n_rows[ci])
        assert (np.diff(rows) > 0).all() and rows[0] == 0
        assert (np.diff(rows) <= pig.TILE_ROWS).all()
        r = t.row0[ci] + rows
        assert (row_item[r[1:]] - row_item[r[:-1]] <= pig.TILE_ITEMS).all()
        np.testing.assert_array_equal(
            tl_r0[lt.tile0[ci]:lt.tile0[ci] + lt.n_tiles[ci]], r[:-1])
        seen = np.zeros(len(t.item_index[ci]), np.int64)
        key = []                     # (weight, piece) of each slot
        ends = np.append(o["pc_g0"][1:], len(o["gr_len"]))
        for k, (s, ln) in enumerate(zip(o["pc_start"], o["pc_len"])):
            groups = range(o["pc_g0"][k], ends[k])
            several += len(groups) > 1
            for q in groups:
                if len(groups) == 1:
                    ids = s + np.arange(ln)
                else:
                    a = o["pc_perm"][k] + o["gr_off"][q]
                    ids = s + o["perm"][a:a + o["gr_len"][q]]
                    assert (np.diff(ids) > 0).all()    # item order
                assert len(set(wid[lo + ids])) == 1
                seen[ids] += 1
                key.append((o["gr_slot"][q], wid[lo + ids[0]], k))
        assert (seen == 1).all()
        key.sort()
        assert [s for s, _, _ in key] == list(range(len(key)))
        assert [(w_, k) for _, w_, k in key] == sorted((w_, k) for _, w_, k
                                                       in key)
        for p0, n, w_ in zip(o["wt_p0"], o["wt_np"], o["wt_wid"]):
            assert {key[s][1] for s in range(p0, p0 + n)} == {w_}
        assert sum(o["wt_np"]) == len(key)
    return several


def _star(n_leaves: int, seed: int):
    """One variable with ``n_leaves`` EQUAL factors to leaves of its own,
    alternating between two learnable weights, with non-dyadic
    featureValues and 30 % evidence: the centre's row holds n_leaves
    items, more than a tile's budget when n_leaves > TILE_ITEMS."""
    from numbskull_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    n = n_leaves + 1
    v = T.new_variables(n)
    v["isEvidence"] = (rng.random(n) < 0.3).astype(np.int8)
    v["initialValue"] = rng.integers(0, 2, n)
    v["cardinality"] = 2
    w = T.new_weights(2)
    w["isFixed"] = False
    w["initialValue"] = (0.1, -0.2)
    f = T.new_factors(n_leaves)
    f["factorFunction"] = T.FUNC_EQUAL
    f["weightId"] = np.arange(n_leaves) % 2
    f["featureValue"] = rng.uniform(0.3, 1.7, n_leaves)
    f["arity"] = 2
    f["ftv_offset"] = 2 * np.arange(n_leaves)
    fm = T.new_fmap(2 * n_leaves)
    fm["vid"][0::2] = 0
    fm["vid"][1::2] = np.arange(1, n)
    return port_compile_graph(w, v, f, fm)


def test_oversized_row_sums_in_pieces():
    """A row with more items than the tile budget is a tile of its own,
    summed in pieces of TILE_ITEMS items: its weight sums equal the
    replay of that order bit for bit and a float64 sum within float32
    rounding, and learning runs through it."""
    cg = _star(5000, 3)
    eng = pig.ItemGridEngine(cg, device="cpu")
    lt = eng.learn_tables()
    rng = np.random.default_rng(4)
    for ci in range(lt.sweep.n_steps):
        o = lt.host[ci]
        n_items = len(lt.sweep.item_index[ci])
        g = (rng.standard_normal(n_items) / 3).astype(np.float32)
        inc = rng.integers(0, 2, n_items).astype(np.int32)
        gs, ns = pig._weight_sums(lt, ci, torch.as_tensor(g),
                                  torch.as_tensor(inc))
        want_g, want_n = _replay_weight_sums(o, g, inc)
        np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                      want_g.view(np.int32))
        np.testing.assert_array_equal(ns.numpy(), want_n)
        wid = lt.sweep.it_wid.numpy()[lt.sweep.item0[ci]:][:n_items]
        for q, w_ in enumerate(o["wt_wid"]):
            sel = wid == w_
            exact = g[sel].astype(np.float64).sum()
            # each sum is at most (entries per lane + 5 halvings) adds
            # deep, twice (pieces, then the weight's partials)
            depth = 2 * (-(-int(sel.sum()) // pig.WARP) + 5)
            tol = depth * 2.0 ** -24 * np.abs(g[sel]).astype(
                np.float64).sum()
            assert abs(float(gs[q]) - exact) <= tol
            assert int(ns[q]) == int(inc[sel].sum())
    centre = [ci for ci in range(lt.sweep.n_steps)
              if lt.sweep.n_rows[ci] == 1]
    assert len(centre) == 1
    o = lt.host[centre[0]]
    assert lt.n_tiles[centre[0]] == 1 and lt.smem_items[centre[0]] == \
        pig.TILE_ITEMS
    np.testing.assert_array_equal(o["pc_len"], [pig.TILE_ITEMS,
                                                5000 - pig.TILE_ITEMS])
    w1, x1, xe1 = eng.learn(5, 1, 3, 0.05, 0.98)
    assert not torch.equal(w1, torch.as_tensor(cg.weight_init,
                                               dtype=torch.float32))


def test_learning_is_deterministic_with_non_dyadic_feature_values():
    """Two runs of the plain learning from one seed, with non-dyadic
    featureValues (sums that round), give the same weight bits."""
    w, v, f, fm, dm, _ = port_lf_model(0.5, [0.9, 0.6, 0.3, 0.8],
                                       copies=400, seed=4)
    f["featureValue"] = np.random.default_rng(5).uniform(0.3, 1.7, len(f))
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    lp = LearnParams(regularization=2, reg_param=0.01,
                     learn_non_evidence=True)
    runs = [pig.ItemGridEngine(cg, device="cpu").learn(3, 2, 6, 0.05, 0.98,
                                                       lp)
            for _ in range(2)]
    w0 = torch.as_tensor(cg.weight_init, dtype=torch.float32)
    assert not torch.equal(runs[0][0], w0)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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
