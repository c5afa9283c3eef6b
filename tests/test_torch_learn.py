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

from _torch_threads import cap_threads

cap_threads()


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


def _spouse2():
    """``chip_smoke.spouse_shape``: DeepDive's spouse graph's shape at
    kmax 2 (rows of 10 to 62 ISTRUE and IMPLY items, runs of 128 rows
    far past ITEM_CUT items), 256 candidates."""
    import chip_smoke
    return jax_compile_graph(*chip_smoke.spouse_shape(128, 7))


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
    # kmax 2, tiles cut at ITEM_CUT items
    "spouse_l2": (_spouse2, dict(regularization=2, reg_param=0.01), 7, 1,
                  2, 0.05, 1.0),
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
        steps = pig.learn_steps(LearnParams(), step0, decay, 1001)
        for i in (0, 1, 7, 63, 149, 1000):
            s = np.float32(step_of(jnp.float32(step0), jnp.float32(decay),
                                   jnp.int32(i)))
            got = np.float32(steps[i].step)
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


@pytest.mark.parametrize("decay", [0.95, 0.999])
@pytest.mark.parametrize("reg", ["L1", "L2"])
def test_learn_steps_over_a_call_match_xla(decay, reg):
    """A 300-epoch call's constants from one vectorised pass: at every
    epoch the step size has the bits of the epoch's own float32 formula
    (0-d tensors, one epoch at a time) and is within
    test_learn_step_constants_match_xla's tolerance of XLA's, and what
    the update derives from it (the L2 shrink, the L1 truncation and
    threshold) has XLA's bits given that step."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step_of(step0, decay, i):
        return step0 * jnp.exp(i.astype(jnp.float32) * jnp.log(decay))

    @jax.jit
    def update_of(step, reg_param, truncation):
        # itemgrid_pallas.py:2505-2511, fmas contracted as there
        return (1.0 / (1.0 + reg_param * step),
                reg_param * step * truncation, 1.0 / truncation)

    lp = LearnParams(regularization=1 if reg == "L1" else 2, reg_param=0.01,
                     truncation=4)
    step0 = 0.05
    steps = pig.learn_steps(lp, step0, decay, 300)
    assert len(steps) == 300

    def f(v):
        return torch.tensor(v, dtype=torch.float32)
    n_equal = 0
    for i, hs in enumerate(steps):
        one = f(step0) * torch.exp(f(float(i)) * torch.log(f(decay)))
        assert np.float32(hs.step).view(np.int32) == \
            np.float32(one).view(np.int32), i
        s = np.float32(step_of(jnp.float32(step0), jnp.float32(decay),
                               jnp.int32(i)))
        tol = 2.0 ** -22 * (2 + abs(i * np.log(decay)))
        assert abs(hs.step - float(s)) <= tol * float(s), (i, hs.step, s)
        n_equal += int(np.float32(hs.step) == s)
        shrink, l1d, thresh = (np.float32(v) for v in update_of(
            jnp.float32(hs.step), jnp.float32(lp.reg_param),
            jnp.float32(lp.truncation)))
        assert (np.float32(hs.shrink), np.float32(hs.l1d),
                np.float32(hs.thresh)) == (shrink, l1d, thresh), i
        assert (hs.regularization, hs.mean, hs.learn_non_evidence) == \
            (lp.regularization, True, False)
    assert n_equal >= 2 * len(steps) // 3


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
        sizes = row_item[r[1:]] - row_item[r[:-1]]
        assert (sizes <= pig.TILE_ITEMS).all()
        if t.kmax <= 2:    # the item kernel's tile, but for a row over it
            assert ((sizes <= pig.ITEM_CUT) | (np.diff(rows) == 1)).all()
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


def _tile_kept(lt, ci, tile: int) -> bool:
    """Whether tile ``tile`` (local to step ``ci``) is in the categorical
    learn step's kept form, written out row by row: kmax above 2, one
    piece, and every
    row's potentials' stride plus a term for each candidate each of its
    items can be evaluated at (a dense item one for each below the row's
    card and kmax, a sparse item two) at most a quarter of KEPT_TERMS."""
    t, o, K = lt.sweep, lt.host[ci], lt.sweep.kmax
    rows = np.append(o["tl_r0"], t.n_rows[ci])
    pieces = np.append(o["tl_pc0"], len(o["pc_start"]))
    if K <= 2 or pieces[tile + 1] - pieces[tile] > 1:
        return False
    for r in range(t.row0[ci] + rows[tile], t.row0[ci] + rows[tile + 1]):
        items = min(int(t.row_item[r + 1] - t.row_item[r]), pig.KEPT_TERMS)
        card = min(int(t.row_card[r]), K)
        if items * max(card, 2) + (K | 1) > pig.KEPT_TERMS // 4:
            return False
    return True


KEPT, CAT = pig.LEARN_FORMS.index("kept"), pig.LEARN_FORMS.index("cat")
ITEM, ROW = pig.LEARN_FORMS.index("item"), pig.LEARN_FORMS.index("row")


def _form_items(lt, ci, form: int) -> int:
    """The items of step ``ci``'s launch in ``form``
    (``LearnTables.launches``), 0 where it has none."""
    return sum(r.items for r in lt.launches[ci] if r.form == form)


def _kept_by_tile(lt, ci) -> int:
    """The items of step ``ci``'s kept tiles, by ``_tile_kept``; the
    tables give the same tiles the kept form (host and device
    ``tl_form``) and record a launch of that many."""
    o, t = lt.host[ci], lt.sweep
    row_item = t.row_item.numpy()
    rows = t.row0[ci] + np.append(o["tl_r0"], t.n_rows[ci])
    kept = [_tile_kept(lt, ci, k) for k in range(len(o["tl_r0"]))]
    forms = lt.tl_form[lt.tile0[ci]:lt.tile0[ci] + lt.n_tiles[ci]].tolist()
    assert o["tl_form"].tolist() == forms
    assert [f == KEPT for f in forms] == kept
    assert sum(r.tiles for r in lt.launches[ci] if r.form == KEPT) == \
        sum(kept)
    return sum(int(row_item[rows[k + 1]] - row_item[rows[k]])
               for k in range(len(o["tl_r0"])) if kept[k])


def _ehr_tiny():
    """The EHR task's shape (``chip_smoke.dp_graph``: 24 LFs) at 120
    candidates: kmax 3, three steps."""
    import chip_smoke
    return pig.ItemGridEngine(port_compile_graph(*chip_smoke.dp_graph(
        120, 24, 7)), device="cpu").learn_tables()


def test_kept_form_takes_every_ehr_step():
    """On the EHR shape (120 candidates x 24 LFs, kmax 3) every step's
    every tile, and so every item, is in the kept form, as the
    tile-by-tile rule counts them."""
    lt = _ehr_tiny()
    t = lt.sweep
    assert t.kmax == 3 and len(lt.launches) == t.n_steps == 3
    for ci in range(t.n_steps):
        n = len(t.item_index[ci])
        assert _form_items(lt, ci, KEPT) == n == _kept_by_tile(lt, ci) > 0
        assert lt.launches[ci] == [(KEPT, lt.n_tiles[ci], n)]


def test_kept_form_leaves_wide_rows_to_the_re_read_form():
    """A card-128 row (Potts 16x16, 4 items of 128 candidates) takes far
    more than a quarter of a warp's terms: no tile is kept. The bipartite
    graph of ``chip_smoke._kept_mixed`` at card 8: the tile holding the
    two 70-item rows is re-read and the step's other tiles kept, the
    count equal to the tile-by-tile rule's. At kmax 2 (the item kernels)
    no tile is kept."""
    import chip_smoke
    from numbskull_tpu_torch.models import ising_color_hint
    from numbskull_tpu_torch.models import potts_grid as port_potts_grid
    w, v, f, fm, dm, _ = port_potts_grid(16, 16, card=128, weight=0.25,
                                         fixed=False)
    lt = pig.ItemGridEngine(port_compile_graph(
        w, v, f, fm, domain_mask=dm, color_hint=ising_color_hint(16, 16)),
        device="cpu").learn_tables()
    assert lt.sweep.kmax == 128 and lt.sweep.n_steps == 2
    assert [_form_items(lt, ci, KEPT) for ci in range(2)] == [0, 0]
    assert (lt.tl_form == CAT).all()
    assert {r.form for rs in lt.launches for r in rs} == {CAT}
    lt = pig.ItemGridEngine(port_compile_graph(*chip_smoke._kept_mixed(
        8, 8)), device="cpu").learn_tables()
    t = lt.sweep
    mixed = 0
    for ci in range(t.n_steps):
        assert _form_items(lt, ci, KEPT) == _kept_by_tile(lt, ci)
        o = lt.host[ci]
        kept = [_tile_kept(lt, ci, k) for k in range(len(o["tl_r0"]))]
        rows = t.row_vid[t.row0[ci]:t.row0[ci] + t.n_rows[ci]].numpy()
        wide = np.flatnonzero(np.isin(rows, (200, 201)))
        for r in wide:   # their tiles are re-read
            assert not kept[np.searchsorted(o["tl_r0"], r, "right") - 1]
        mixed += any(kept) and not all(kept)
    assert mixed and 0 < sum(_form_items(lt, ci, KEPT) for ci in range(
        t.n_steps)) < len(lt.it_fv)
    w, v, f, fm, dm, _ = coin_model(300, 0.8, -0.5, 0.4, evidence=True,
                                    fixed=False, seed=3)
    coin = pig.ItemGridEngine(port_compile_graph(w, v, f, fm,
                                                 domain_mask=dm),
                              device="cpu").learn_tables()
    star = pig.ItemGridEngine(_star(5000, 2), device="cpu").learn_tables()
    for kmax2 in (coin, star):
        assert kmax2.sweep.kmax == 2 and not (kmax2.tl_form == KEPT).any()
        assert [_form_items(kmax2, ci, KEPT) for ci in range(
            kmax2.sweep.n_steps)] == [0] * kmax2.sweep.n_steps
        for ci in range(kmax2.sweep.n_steps):
            assert _kept_by_tile(kmax2, ci) == 0


class _FakeLearnLib:
    """Records the step and sum launches, and launches nothing."""

    def __init__(self):
        self.steps = []

    def nsx_learn_step(self, *args):
        self.steps.append(args)
        return 0

    def nsx_learn_sum(self, *args):
        return 0


def _fake_launches(monkeypatch, lt):
    """A fake library in place of the card's (CPU tensors for its
    memory), and ``launch(ci, keys)``: the launches of learn step ``ci``
    (:func:`pig._launch_learn`), returning what they added to the
    registry counters ``keys``."""
    from numbskull_tpu_torch.observability import metrics
    t = lt.sweep
    fake = _FakeLearnLib()
    monkeypatch.setattr(pig, "LEARN_LAUNCHES", 0)
    monkeypatch.setattr(pig, "_kernel_lib", lambda name="": fake)
    monkeypatch.setattr(pig, "_stream", lambda device: None)
    monkeypatch.setattr(t, "ptrs", (None,) * len(pig._TABLE_FIELDS))
    monkeypatch.setattr(lt, "ptrs", {k: 1 + i for i, k in enumerate((
        "it_fv", "w_fixed", "wt_wid", "wt_p0", "wt_np") + pig._ORDER_FIELDS)})
    x = torch.zeros(t.n_vars, dtype=torch.int32)
    w = torch.zeros(t.n_weights, dtype=torch.float32)
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]

    def launch(ci, keys):
        c0 = metrics.snapshot()["counters"]
        pig._launch_learn(lt, ci, x, x.clone(), w, 1, 1 << 16, hs)
        c1 = metrics.snapshot()["counters"]
        return {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in keys}
    return fake, launch


@pytest.mark.parametrize("graph", ["ehr", "kept_mixed"])
def test_learn_launch_counts_items(monkeypatch, graph):
    """Each learn step adds its items to the registry counter
    ``learn.items`` and its kept tiles' items to ``learn.kept_items``,
    from the tables and with no sync, and launches the step kernel once
    for each form its tiles take (the ``form`` argument: `cat`,
    learn_cat_kernel, or `kept`, learn_kept_kernel), re-read first, the
    tiles' forms (``tl_form``) passed only to a step of both (a fake
    library stands in for the card's, CPU tensors for its memory): over
    an epoch, every item once. The EHR shape's steps are kept, one
    launch each; the bipartite graph of ``chip_smoke._kept_mixed`` at
    card 8 has a step of both forms."""
    import chip_smoke
    lt = _ehr_tiny() if graph == "ehr" else pig.ItemGridEngine(
        port_compile_graph(*chip_smoke._kept_mixed(8, 8)),
        device="cpu").learn_tables()
    t = lt.sweep
    fake, launch = _fake_launches(monkeypatch, lt)
    at = len(pig._TABLE_FIELDS) + 10 + pig._ORDER_FIELDS.index("tl_form")
    total = kept = 0
    forms = []
    for ci in range(t.n_steps):
        n0 = len(fake.steps)
        d = launch(ci, ("learn.items", "learn.kept_items"))
        assert d == {"learn.items": len(t.item_index[ci]),
                     "learn.kept_items": _kept_by_tile(lt, ci)}
        total += d["learn.items"]
        kept += d["learn.kept_items"]
        # the form before the stream
        forms.append([a[-2] for a in fake.steps[n0:]])
        assert forms[-1] == sorted({KEPT if _tile_kept(lt, ci, k) else CAT
                                    for k in range(lt.n_tiles[ci])})
        assert {a[at] for a in fake.steps[n0:]} == {
            lt.ptrs["tl_form"] if len(forms[-1]) == 2 else None}
    assert total == len(lt.it_fv) and 0 < kept <= total
    assert pig.LEARN_LAUNCHES == len(fake.steps) + t.n_steps
    if graph == "ehr":
        assert forms == [[KEPT]] * t.n_steps and kept == total
    else:
        assert [CAT, KEPT] in forms and kept < total


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
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]
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
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]
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


# ---- kmax 2: tiles cut at ITEM_CUT items, for the item kernel ------------

def _greedy_reference(counts, budget: int) -> np.ndarray:
    """The greedy cut row by row: a tile takes rows while it has fewer
    than TILE_ROWS and its items stay within ``budget``; a row over the
    budget is a tile of its own."""
    out, s, n = [], 0, len(counts)
    while s < n:
        out.append(s)
        e, items = s, 0
        while e < n and e - s < pig.TILE_ROWS and items + counts[e] <= budget:
            items += counts[e]
            e += 1
        s = max(e, s + 1)
    return np.asarray(out, np.int64)


def _runs_reference(counts) -> np.ndarray:
    """The cut above kmax 2, row by row: runs of TILE_ROWS rows, a run of
    more than TILE_ITEMS items cut greedily within it."""
    return np.concatenate([
        a + _greedy_reference(counts[a:a + pig.TILE_ROWS], pig.TILE_ITEMS)
        for a in range(0, len(counts), pig.TILE_ROWS)]).astype(np.int64)


def _counts(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    spouse = rng.integers(10, 63, 3000)
    return {"spouse rows": spouse,
            "ising rows": np.full(1000, 4),
            "empty rows": np.where(rng.random(3000) < 0.3, 0, spouse),
            "row of 1000": np.insert(spouse, 700, 1000),
            "row of 1100": np.insert(spouse, 700, 1100),
            "row of 5000": np.insert(spouse, 700, 5000),
            "one row": np.array([30])}[case]


COUNT_CASES = ["spouse rows", "ising rows", "empty rows", "row of 1000",
               "row of 1100", "row of 5000", "one row"]


@pytest.mark.parametrize("case", COUNT_CASES)
def test_tile_cut_against_row_by_row(case):
    """_cut_tiles at kmax 2 == the greedy cut at ITEM_CUT items over the
    step's rows, and above it == the runs of TILE_ROWS rows cut at
    TILE_ITEMS, on the same rows; where every run of TILE_ROWS rows fits
    ITEM_CUT (a 4-item Ising row) both are the runs."""
    counts = _counts(case)
    np.testing.assert_array_equal(pig._cut_tiles(counts, 2),
                                  _greedy_reference(counts, pig.ITEM_CUT))
    for kmax in (3, 8, 128):
        np.testing.assert_array_equal(pig._cut_tiles(counts, kmax),
                                      _runs_reference(counts))
    if case == "ising rows":
        np.testing.assert_array_equal(pig._cut_tiles(counts, 2),
                                      np.arange(0, 1000, pig.TILE_ROWS))


@pytest.mark.parametrize("big", [1000, 1100, 5000])
def test_kmax2_row_over_the_item_tile_is_a_tile_of_its_own(big):
    """A row of more than ITEM_CUT items among spouse rows is a tile of
    its own, summed in pieces of TILE_ITEMS items, while every other tile
    holds at most ITEM_CUT items; the step's longest piece is that row's
    first, so a row of at most ITEM_TILE items (1,000) leaves the step to
    learn_item_kernel, and one of more (1,100, 5,000) gives it to
    learn_step_kernel."""
    counts = _counts("row of %d" % big)
    wl = np.random.default_rng(3).integers(0, 50, int(counts.sum()))
    o = pig._step_order(counts, wl, 2)
    ts = o["tl_r0"]
    k = int(np.flatnonzero(ts == 700)[0])
    assert ts[k + 1] == 701
    pieces = np.append(o["tl_pc0"], len(o["pc_len"]))
    np.testing.assert_array_equal(
        o["pc_len"][pieces[k]:pieces[k + 1]],
        [min(big, pig.TILE_ITEMS)] + ([big - pig.TILE_ITEMS]
                                      if big > pig.TILE_ITEMS else []))
    assert o["smem_items"] == min(big, pig.TILE_ITEMS)
    assert (o["smem_items"] > pig.ITEM_TILE) == (big > pig.ITEM_TILE)
    cum = np.concatenate(([0], np.cumsum(counts)))
    sizes = np.diff(cum[np.append(ts, len(counts))])
    assert (np.delete(sizes, k) <= pig.ITEM_CUT).all()


def _spouse_tables(schedule: str):
    """The spouse shape's learn tables under the port's schedule or the
    JAX plan's."""
    cg = _spouse2()
    if schedule == "jax plan":
        return _port_engine(cg)[0].learn_tables()
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    return pig.ItemGridEngine(pcg, device="cpu").learn_tables()


@pytest.mark.parametrize("schedule", ["port", "jax plan"])
def test_kmax2_tiles_fit_the_item_kernel(schedule):
    """The spouse shape at kmax 2 (rows of 10 to 62 items, a step's 128
    rows about 4,500 items): every tile holds at most TILE_ROWS rows and
    ITEM_CUT items and is full (TILE_ROWS rows, or its next row would
    pass ITEM_CUT), so every step's longest piece fits learn_item_kernel;
    the order tables cover every item once, and the weight sums follow
    the kernels' documented order on non-dyadic gradients."""
    lt = _spouse_tables(schedule)
    t = lt.sweep
    assert t.kmax == 2 and _check_order_tables(lt) > 0
    row_item = t.row_item.numpy()
    rng = np.random.default_rng(6)
    for ci in range(t.n_steps):
        o, r0 = lt.host[ci], t.row0[ci]
        counts = np.diff(row_item[r0:r0 + t.n_rows[ci] + 1])
        assert counts[:pig.TILE_ROWS].sum() > 4 * pig.ITEM_CUT
        rows = np.append(o["tl_r0"], t.n_rows[ci])
        cum = np.concatenate(([0], np.cumsum(counts)))
        sizes = np.diff(cum[rows])
        assert (np.diff(rows) <= pig.TILE_ROWS).all()
        assert (sizes <= pig.ITEM_CUT).all()
        full = (np.diff(rows)[:-1] == pig.TILE_ROWS) | (
            sizes[:-1] + counts[rows[1:-1]] > pig.ITEM_CUT)
        assert full.all()
        assert lt.smem_items[ci] <= pig.ITEM_CUT <= pig.ITEM_TILE
        assert len(o["pc_len"]) == len(o["tl_r0"])   # a piece a tile
        n_items = len(t.item_index[ci])
        g = (rng.standard_normal(n_items) / 3).astype(np.float32)
        inc = rng.integers(0, 2, n_items).astype(np.int32)
        gs, ns = pig._weight_sums(lt, ci, torch.as_tensor(g),
                                  torch.as_tensor(inc))
        want_g, want_n = _replay_weight_sums(o, g, inc)
        np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                      want_g.view(np.int32))
        np.testing.assert_array_equal(ns.numpy(), want_n)


def _parent_cut(counts, kmax):
    """The cut before kmax 2 had its own: runs of TILE_ROWS rows cut at
    TILE_ITEMS at every kmax."""
    return _runs_reference(np.asarray(counts, np.int64))


def _tables_equal(a, b):
    for k in ("tile0", "n_tiles", "smem_items", "wt0", "n_wt", "n_big",
              "launches"):
        assert getattr(a, k) == getattr(b, k), k
    for k in pig._ORDER_FIELDS + ("wt_wid", "wt_p0", "wt_np"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for oa, ob in zip(a.host, b.host, strict=True):
        assert oa.keys() == ob.keys()
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)


@pytest.mark.parametrize("graph", ["ehr", "ehr 600", "kept_mixed",
                                   "potts card 128", "coin", "ising16"])
def test_tables_unchanged_where_the_cut_is(monkeypatch, graph):
    """Above kmax 2 (the EHR shape at 120 and at 600 candidates, whose
    class runs pass TILE_ITEMS; the bipartite graph of
    ``chip_smoke._kept_mixed``; Potts at card 128) and on kmax-2 graphs
    whose 128-row runs fit ITEM_CUT (coin, Ising), the learn tables equal,
    array for array, those of the cut at TILE_ITEMS items in runs of
    TILE_ROWS rows at every kmax."""
    import chip_smoke
    from numbskull_tpu_torch.models import ising_color_hint
    from numbskull_tpu_torch.models import potts_grid as port_potts_grid
    if graph.startswith("ehr"):
        cg = port_compile_graph(*chip_smoke.dp_graph(
            600 if graph == "ehr 600" else 120, 24, 7))
    elif graph == "kept_mixed":
        cg = port_compile_graph(*chip_smoke._kept_mixed(8, 8))
    elif graph == "potts card 128":
        w, v, f, fm, dm, _ = port_potts_grid(16, 16, card=128, weight=0.25,
                                             fixed=False)
        cg = port_compile_graph(w, v, f, fm, domain_mask=dm,
                                color_hint=ising_color_hint(16, 16))
    else:
        cg = compiled_graph_from_reference(dataclasses.asdict(
            _coin() if graph == "coin" else _ising16()))
    lt = pig.ItemGridEngine(cg, device="cpu").learn_tables()
    monkeypatch.setattr(pig, "_cut_tiles", _parent_cut)
    _tables_equal(lt, pig.ItemGridEngine(cg, device="cpu").learn_tables())
    if graph == "ehr 600":    # a run of TILE_ROWS class rows is cut
        t = lt.sweep
        assert any(t.row_item[t.row0[ci] + pig.TILE_ROWS] -
                   t.row_item[t.row0[ci]] > pig.TILE_ITEMS and
                   lt.host[ci]["tl_r0"][1] < pig.TILE_ROWS
                   for ci in range(t.n_steps)
                   if t.n_rows[ci] > pig.TILE_ROWS)


def test_kmax2_learning_is_deterministic_with_non_dyadic_feature_values():
    """Two runs of the plain learning on the spouse shape from one seed,
    featureValues in [0.3, 1.7] (sums that round, in the order the
    ITEM_CUT tiles fix), give the same weight and chain bits, and the
    weights move."""
    import chip_smoke
    cg = port_compile_graph(*chip_smoke.spouse_shape(
        160, 7, fv=lambda rng, n: rng.uniform(0.3, 1.7, n)))
    runs = [pig.ItemGridEngine(cg, device="cpu").learn(
        3, 1, 4, 0.05, 0.98, LearnParams(regularization=2, reg_param=0.01))
        for _ in range(2)]
    assert not torch.equal(runs[0][0], torch.as_tensor(
        cg.weight_init, dtype=torch.float32))
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("graph", ["spouse", "hub"])
def test_kmax2_launch_counts_item_form_items(monkeypatch, graph):
    """A kmax-2 step is one launch in the `item` form (learn_item_kernel)
    where its longest piece holds at most ITEM_TILE items, else in the
    `row` form (learn_step_kernel), with no ``tl_form``, and adds its
    items to the registry counter ``learn.item_form_items`` in the item
    form, else 0, from the tables and with no sync: every item of the
    spouse shape; on the star of 1,100 leaves, all but the hub's, whose
    1,100-item row keeps learn_step_kernel."""
    if graph == "spouse":
        lt = _spouse_tables("port")
    else:
        lt = pig.ItemGridEngine(_star(1100, 2), device="cpu").learn_tables()
    t = lt.sweep
    fake, launch = _fake_launches(monkeypatch, lt)
    at = len(pig._TABLE_FIELDS) + 10 + pig._ORDER_FIELDS.index("tl_form")
    form = 0
    for ci in range(t.n_steps):
        n0 = len(fake.steps)
        d = launch(ci, ("learn.items", "learn.item_form_items"))
        n = len(t.item_index[ci])
        item = lt.smem_items[ci] <= pig.ITEM_TILE
        assert d == {"learn.items": n, "learn.item_form_items":
                     n if item else 0}
        assert [(a[-2], a[at]) for a in fake.steps[n0:]] == [
            (ITEM if item else ROW, None)]
        form += d["learn.item_form_items"]
    if graph == "spouse":
        assert form == len(lt.it_fv)
    else:
        assert form == len(lt.it_fv) - 1100 and max(lt.smem_items) == 1100


def _forms_graph(graph: str):
    """The learn tables of ``test_learn_tables_record_each_tiles_form``'s
    graph ``graph``."""
    import chip_smoke
    if graph == "spouse":
        return _spouse_tables("port")
    if graph == "ehr":
        return _ehr_tiny()
    if graph == "hub":
        cg = _star(1100, 2)
    elif graph == "kept_mixed":
        cg = port_compile_graph(*chip_smoke._kept_mixed(8, 8))
    else:    # phase 13's EQUAL graph at card 32, with its wide row
        cg = port_compile_graph(*chip_smoke.factor_fixtures_of(
            "EQUAL", ("cat32",))[0][2])
    return pig.ItemGridEngine(cg, device="cpu").learn_tables()


# per step, the form of each tile, as the rules give them: at kmax 2 every
# tile `item` unless the step's longest piece passes ITEM_TILE (the hub
# row of 1,100 items, `row`); above it `kept` where every row of a
# one-piece tile fits a quarter of a warp's terms, else `cat`
RECORDED_FORMS = {
    "spouse": [["item"] * 6, ["item"] * 6],
    "hub": [["row"], ["item"] * 9],
    "ehr": [["kept"] * 19, ["kept"] * 4, ["kept"] * 2],
    "kept_mixed": [["kept", "cat", "kept", "kept"], ["kept"] * 4],
    "cat32 wide": [["kept"], ["kept"], ["kept"], ["cat"], ["kept"],
                   ["cat"]],
}


@pytest.mark.parametrize("graph", sorted(RECORDED_FORMS))
def test_learn_tables_record_each_tiles_form(graph):
    """build_learn_tables gives every tile its form (host ``tl_form`` ==
    device ``tl_form``), as written out in RECORDED_FORMS, and records a
    step's launches, one per form its tiles take in LEARN_FORMS order,
    each with its tiles and their items; at kmax 2 a step's tiles take
    one form. On phase 13's card-32 graph the wide row (variable 0, the
    last argument of WIDE_FACTORS factors) is in a `cat` tile."""
    import chip_smoke
    lt = _forms_graph(graph)
    t = lt.sweep
    row_item = t.row_item.numpy()
    got = []
    for ci in range(t.n_steps):
        o = lt.host[ci]
        form = o["tl_form"]
        assert form.tolist() == lt.tl_form[
            lt.tile0[ci]:lt.tile0[ci] + lt.n_tiles[ci]].tolist()
        got.append([pig.LEARN_FORMS[f] for f in form])
        rows = t.row0[ci] + np.append(o["tl_r0"], t.n_rows[ci])
        items = row_item[rows[1:]] - row_item[rows[:-1]]
        assert lt.launches[ci] == [
            (f, int((form == f).sum()), int(items[form == f].sum()))
            for f in range(len(pig.LEARN_FORMS)) if (form == f).any()]
        assert sum(r.items for r in lt.launches[ci]) == \
            len(t.item_index[ci])
        if t.kmax <= 2:
            assert len(lt.launches[ci]) == 1
    assert got == RECORDED_FORMS[graph]
    if graph == "cat32 wide":
        ci = next(c for c in range(t.n_steps) if 0 in
                  t.row_vid[t.row0[c]:t.row0[c] + t.n_rows[c]].tolist())
        assert got[ci] == ["cat"] and t.n_rows[ci] == 1
        assert row_item[t.row0[ci] + 1] - row_item[t.row0[ci]] >= \
            chip_smoke.WIDE_FACTORS
