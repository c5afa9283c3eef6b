"""The categorical kernels' walk (kmax 3 to 128), on the CPU.

``sweep_cat_kernel`` and ``learn_cat_kernel`` (``csrc/itemgrid_sweep.cu``,
``csrc/itemgrid_learn.cu``) sum a block's potentials through
``cat_potentials`` (``csrc/itemgrid_common.cuh``), each of its CAT_WARPS
warps a quarter of its rows: a warp's items in chunks of at most WARP
items, CAT_ARGS staged argument values and CAT_TERMS (item, candidate)
terms, the terms placed by a scan of each item's count (a dense item
one for each candidate below its row's card, a sparse item one for each
of d1 and d2 below kmax), groups of lanes an item's candidates, then
each (row, candidate) of the rows a chunk touches adding its terms in
item order. The kernels cannot run here, so
``cat_walk`` below writes that index arithmetic out, and these tests
hold it: with the tiles the wrapper picks (``cat_tile_rows``; a learn
tile's warps in runs, ``learn_runs``), every row is drawn once, every
item is evaluated once at each candidate the dense / d1 / d2 rule keeps
and at no other, each (row, candidate) adds exactly its own items'
terms in item order, and no chunk outgrows its shared memory; the
learn kernel's gradient pass takes every item once: in a kept run
from the run's terms, which fit a warp's KEPT_TERMS beside the run's
potentials, otherwise one evaluation per piece. Then a plain replay of
that order (terms from ``eval_items_at``, added chunk by chunk) equals
``color_step_reference``'s potentials bit for bit, and its draws the
plain version's, on phase 2's categorical fixtures and phase 13's cat
graphs. ``chip_smoke.py`` holds the kernels to the plain versions on
the card.
"""

import numpy as np
import pytest
import torch

from numbskull_tpu_torch import models as M
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import eval_items_at

import chip_smoke
from _torch_threads import cap_threads

cap_threads()


def _terms(meta, card, K):
    """The candidates of an item's terms, in term order (the kernel's
    term count and ``sparse_k``)."""
    if meta & pig.META_DENSE:
        return list(range(min(card, K)))
    d1 = (meta >> pig.META_D1_SHIFT) & 255
    d2 = (meta >> pig.META_D2_SHIFT) & 255
    return [d for d in (d1, d2)[:1 if d1 == d2 else 2] if d < K]


def warp_runs(r0, nr):
    """``warp_rows``: a block's rows [r0, r0 + nr) as (first row, rows)
    of each warp that has rows."""
    per = -(-nr // pig.CAT_WARPS)
    return [(r0 + w * per, min(per, nr - w * per))
            for w in range(pig.CAT_WARPS) if w * per < nr]


def cat_walk(row_item, it_arg, it_meta, row_card, K, r0, nr):
    """``cat_potentials`` of one warp over rows [r0, r0 + nr): returns
    the chunks (first item, items, staged, arguments, terms), each
    (item, candidate) evaluated with how often, and each (row,
    candidate)'s added items in order."""
    assert 1 <= nr <= pig.WARP
    T0 = int(row_item[r0])
    ri = [int(row_item[r0 + i]) - T0 for i in range(nr + 1)]
    n_items = ri[nr]
    evaluated, added, chunks = {}, {}, []
    c0 = 0
    while c0 < n_items:
        live = range(c0, min(c0 + pig.WARP, n_items))
        rows = [max(r for r in range(nr) if ri[r] <= j) for j in live]
        cand = [_terms(int(it_meta[T0 + j]), int(row_card[r0 + r]), K)
                for j, r in zip(live, rows)]
        ar = [min(int(it_arg[T0 + j + 1] - it_arg[T0 + j]), pig.CAT_ARGS + 1)
              for j in live]
        pre_t, pre_a = np.cumsum([len(c) for c in cand]), np.cumsum(ar)
        fits = (pre_t <= pig.CAT_TERMS) & (pre_a <= pig.CAT_ARGS)
        assert fits.tolist() == sorted(fits.tolist(), reverse=True)
        nf = int(fits.sum())
        n = max(nf, 1)
        chunks.append((c0, n, nf > 0, int(pre_a[n - 1]), int(pre_t[n - 1])))
        # groups of L lanes, the most that give each item a group; a
        # group's lanes its candidates
        L = pig.WARP // (1 << (n - 1).bit_length())
        for lane in range(pig.WARP):
            j = lane // L
            for s in range(lane % L, len(cand[j]) if j < n else 0, L):
                key = (T0 + c0 + j, cand[j][s])
                evaluated[key] = evaluated.get(key, 0) + 1
        for r in range(rows[0], rows[n - 1] + 1):
            for k in range(K):
                for j in range(max(ri[r], c0), min(ri[r + 1], c0 + n)):
                    if k in cand[j - c0]:
                        added.setdefault((r0 + r, k), []).append(T0 + j)
        c0 += n
    return chunks, evaluated, added


def _check_walk(row_item, it_arg, it_meta, row_card, K, row0, n_rows,
                runs):
    """``runs``: (first row, rows) of each warp's run of the potential
    pass; returns the terms of each run's chunks."""
    drawn = np.zeros(n_rows, np.int64)
    evaluated, added, terms = {}, {}, []
    for r0, nr in runs:
        chunks, ev, ad = cat_walk(row_item, it_arg, it_meta, row_card, K,
                                  r0, nr)
        for c0, n, staged, na, nt in chunks:
            assert 1 <= n <= pig.WARP and nt <= pig.CAT_TERMS
            assert na <= pig.CAT_ARGS if staged else n == 1
        terms.append(sum(c[4] for c in chunks))
        for key, c in ev.items():
            evaluated[key] = evaluated.get(key, 0) + c
        added.update(ad)
        drawn[r0 - row0:r0 - row0 + nr] += 1
    assert (drawn == 1).all()
    for i in range(n_rows):
        r = row0 + i
        items = range(int(row_item[r]), int(row_item[r + 1]))
        for k in range(K):
            want = [it for it in items
                    if k in _terms(int(it_meta[it]), int(row_card[r]), K)]
            assert added.get((r, k), []) == want, (r, k)
            for it in want:
                assert evaluated.pop((it, k)) == 1
    assert not evaluated    # no candidate evaluated that no row adds
    return terms


def sweep_runs(tiles, K):
    """The sweep's warps' runs: ``warp_runs`` of each block of
    ``tiles`` (first row, rows), whose potentials fit CAT_POT_FLOATS."""
    runs = []
    for b0, bn in tiles:
        assert 1 <= bn <= pig.CAT_THREADS
        assert bn * pig.cat_stride(K) <= pig.CAT_POT_FLOATS
        runs += warp_runs(b0, bn)
    return runs


def learn_runs(row_item, row_card, K, tiles):
    """The categorical learn kernels' runs over a step's tiles (first
    row, rows, kept): (first row, rows, kept) of every warp's run. A kept
    tile (``kept_tiles``; ``learn_kept_kernel``): each warp's quarter
    (``warp_rows``) in runs of the most rows (at most WARP) whose
    ``kept_terms`` sum to at most KEPT_TERMS; any other tile
    (``learn_cat_kernel``) ``cat_pot_rows`` rows at a time, each warp a
    quarter of them."""
    out = []
    pr = pig.cat_pot_rows(K)
    for a, bn, kept in tiles:
        if not kept:
            out += [(r0, nr, False) for s in range(a, a + bn, pr)
                    for r0, nr in warp_runs(s, min(pr, a + bn - s))]
            continue
        need = pig.kept_terms(np.diff(row_item[a:a + bn + 1]),
                              row_card[a:a + bn], K)
        for r0, wr in warp_runs(a, bn):
            r = r0
            while r < r0 + wr:
                cum = np.cumsum(need[r - a:r - a + min(pig.WARP,
                                                       r0 + wr - r)])
                wn = int((cum <= pig.KEPT_TERMS).sum())
                assert wn >= 1
                out.append((r, wn, True))
                r += wn
    return out


def _step(rng, n_rows, K, long_row=None, dense=0.7):
    """One step's tables (CSR offsets, packed items, row cards) after 3
    rows of another step: 0 to 9 items a row of arity 1 to 4 and four
    factor types, cards 2 to K, dense items a share ``dense`` (the others
    sparse with slots up to 255), and, given ``long_row``, one row of
    that many items."""
    counts = rng.integers(0, 10, n_rows)
    if long_row is not None:
        counts[n_rows // 2] = long_row
    counts = np.concatenate(([2, 0, 5], counts))
    n_items = int(counts.sum())
    row_item = np.concatenate(([0], np.cumsum(counts)))
    arity = rng.integers(1, 5, n_items)
    it_arg = np.concatenate(([0], np.cumsum(arity)))
    d1 = rng.integers(0, K, n_items)
    d2 = np.where(rng.random(n_items) < 0.2, d1, rng.integers(0, 256,
                                                              n_items))
    it_meta = pig.pack_items(rng.choice([3, 12, 15, 21], n_items),
                             rng.random(n_items) < dense, d1, d2)
    row_card = rng.integers(2, K + 1, len(counts))
    return row_item, it_arg, it_meta, row_card, 3, n_rows


STEPS = [(n, K, None) for K in (8, 32, 128) for n in (1, 127, 128, 129)]
STEPS += [(40, K, 5000) for K in (8, 128)]   # a row of two learn pieces
STEPS += [(40, K, 300) for K in (8, 32, 128)]   # a row longer than a chunk
STEPS += [(64, 128, None, 1.0), (64, 128, None, 0.0)]  # card-128 dense,
#                                                         sparse


@pytest.mark.parametrize("case", STEPS, ids=[
    "%d rows kmax %d%s%s" % (c[0], c[1], " row of %d" % c[2] if c[2] else "",
                             "" if len(c) < 4 else " dense %g" % c[3])
    for c in STEPS])
def test_sweep_tiles_cover_every_row_item_and_candidate_once(case):
    """The sweep's tiles of ``cat_tile_rows`` rows."""
    n, K, long_row = case[:3]
    rng = np.random.default_rng(n * K + (long_row or 0))
    row_item, it_arg, it_meta, row_card, row0, n_rows = _step(
        rng, n, K, long_row, *case[3:])
    tr = pig.cat_tile_rows(n_rows, int(row_item[-1] - row_item[row0]), K)
    tiles = [(row0 + i, min(tr, n_rows - i)) for i in range(0, n_rows, tr)]
    _check_walk(row_item, it_arg, it_meta, row_card, K, row0, n_rows,
                sweep_runs(tiles, K))


@pytest.mark.parametrize("case", STEPS[:14], ids=[
    "%d rows kmax %d%s" % (c[0], c[1], " row of %d" % c[2] if c[2] else "")
    for c in STEPS[:14]])
def test_learn_tiles_cover_every_row_item_and_candidate_once(case):
    """A learn step's tiles (``build_learn_tables``' cut, unchanged),
    each warp's rows in runs (``learn_runs``) in the form ``kept_tiles``
    gives its tile: a kept run's potentials and terms fit its warp's
    KEPT_TERMS, a re-read run is a warp's share of ``cat_pot_rows``
    rows; every item's gradient taken once."""
    n, K, long_row = case
    rng = np.random.default_rng(n * K + 1)
    row_item, it_arg, it_meta, row_card, row0, n_rows = _step(rng, n, K,
                                                              long_row)
    counts = np.diff(row_item[row0:])
    ts = pig._cut_tiles(counts, K)
    ends = np.append(ts[1:], n_rows)
    npc = [-(-int(counts[a:e].sum()) // pig.TILE_ITEMS)
           for a, e in zip(ts, ends)]
    o = {"tl_r0": ts, "tl_pc0": np.cumsum([0] + npc[:-1]),
         "pc_start": np.zeros(sum(npc))}
    tile_kept = pig.kept_tiles(o, counts, row_card[row0:], K)
    runs = learn_runs(row_item, row_card, K,
                      [(row0 + a, e - a, k) for a, e, k in
                       zip(ts, ends, tile_kept)])
    terms = _check_walk(row_item, it_arg, it_meta, row_card, K, row0,
                        n_rows, [(r0, nr) for r0, nr, _ in runs])
    S = pig.cat_stride(K)
    seen = np.zeros(int(row_item[-1]), np.int64)
    for (r0, nr, kept), nt in zip(runs, terms):
        if kept:    # potentials and kept terms side by side
            assert nr <= pig.WARP and nr * S + nt <= pig.KEPT_TERMS
            seen[int(row_item[r0]):int(row_item[r0 + nr])] += 1
        else:    # a warp's quarter of cat_pot_rows rows
            assert nr <= -(-pig.cat_pot_rows(K) // pig.CAT_WARPS)
    assert int(seen.sum()) == sum(int(counts[a:e].sum()) for a, e, k in
                                  zip(ts, ends, tile_kept) if k)
    # the re-read tiles' gradient pass: a quarter of each piece's items a
    # warp, in chunks of at most WARP items and CAT_ARGS staged
    # arguments, each item once
    kept_rows = {r for r0, nr, kept in runs if kept
                 for r in range(r0, r0 + nr)}
    for a, e in zip(ts, ends):
        if row0 + a in kept_rows:
            continue
        T0, T1 = int(row_item[row0 + a]), int(row_item[row0 + e])
        for P0 in range(T0, T1, pig.TILE_ITEMS):
            P1 = min(P0 + pig.TILE_ITEMS, T1)
            per = -(-(P1 - P0) // pig.CAT_WARPS)
            for w in range(pig.CAT_WARPS):
                c0, Q1 = min(P1, P0 + w * per), min(P1, P0 + (w + 1) * per)
                while c0 < Q1:
                    ar = np.minimum(np.diff(it_arg[c0:min(c0 + pig.WARP,
                                                          Q1) + 1]),
                                    pig.CAT_ARGS + 1)
                    n = max(int((np.cumsum(ar) <= pig.CAT_ARGS).sum()), 1)
                    seen[c0:c0 + n] += 1
                    c0 += n
    assert (seen[int(row_item[row0]):] == 1).all()


def test_tile_choice():
    """The wrapper's tiles on the main paths' shapes: 128 rows at kmax 3
    to 32 where the step has rows for SWEEP_BLOCKS such blocks (the DP
    and LF colors), 64 at kmax 64 and 32 at 128; 32 on Potts 256x256
    (32,768 rows a color of 4 items each, the tile that still gives
    SWEEP_BLOCKS blocks); never more potentials than a block holds; a
    learn tile's potential pass 128 rows up to kmax 32, 32 at 128."""
    assert pig.cat_tile_rows(2_000_000, 8_000_000, 3) == 128
    assert pig.cat_tile_rows(200_000, 8_000_000, 3) == 128
    assert pig.cat_tile_rows(2_000_000, 8_000_000, 32) == 128
    assert pig.cat_tile_rows(2_000_000, 8_000_000, 64) == 64
    assert pig.cat_tile_rows(2_000_000, 8_000_000, 128) == 32
    assert pig.cat_tile_rows(32768, 131072, 32) == 32
    assert pig.cat_tile_rows(32768, 131072, 128) == 32
    for K in range(3, 129):
        for n in (1, 7, 1000, 100_000):
            tr = pig.cat_tile_rows(n, 4 * n, K)
            assert tr & (tr - 1) == 0 and 1 <= tr <= pig.CAT_THREADS
            assert tr * pig.cat_stride(K) <= pig.CAT_POT_FLOATS
        assert pig.cat_pot_rows(K) * pig.cat_stride(K) <= pig.CAT_POT_FLOATS
    assert [pig.cat_pot_rows(K) for K in (3, 8, 32, 128)] == \
        [128, 128, 128, 32]


def replayed_potentials(t, ci, x, w):
    """Step ``ci``'s potentials (n_rows, kmax) summed in the categorical
    kernels' order: tile after tile, chunk after chunk (``cat_walk``),
    each term w x e of an item at a candidate, added per (row,
    candidate) in item order from +0.0."""
    lo, n, K = t.row0[ci], t.n_rows[ci], t.kmax
    pd = t.plan_tensors(ci)
    w_it = w[pd["it_wid"]]
    ev = [w_it * eval_items_at(pd, t.present[ci], x,
                               torch.full_like(pd["it_row"], k))
          for k in range(K)]
    row_item = t.row_item.numpy()
    it0 = int(row_item[lo])
    tr = t.item_shape[ci][0]
    pot = torch.zeros((n, K), dtype=torch.float32)
    added = {}
    for i0 in range(0, n, tr):
        for r0, nr in warp_runs(lo + i0, min(tr, n - i0)):
            added.update(cat_walk(row_item, t.it_arg.numpy(),
                                  t.it_meta.numpy(), t.row_card.numpy(), K,
                                  r0, nr)[2])
    for (r, k), items in added.items():
        acc = torch.zeros((), dtype=torch.float32)
        for it in items:
            acc = acc + ev[k][it - it0]
        pot[r - lo, k] = acc
    return pot


def _cat_fixtures():
    """Phase 2's categorical fixtures (smaller) and phase 13's cat
    graphs of a few codes at each of the three forms."""
    out = {"lf_card3": compile_graph(*M.lf_model(
        0.5, [0.5, 0.25, 0.75], copies=60, seed=1)[:4])}
    for card in (20, 64, 128):
        w, v, f, fm, dm, _ = M.potts_grid(6, 6, card=card, weight=0.25)
        out["potts6_card%d" % card] = compile_graph(
            w, v, f, fm, domain_mask=dm, color_hint=M.ising_color_hint(6, 6))
    for name in ("EQUAL", "IMPLY_MLN_CAT", "UFO", "DP_GEN_LF_ACCURACY"):
        for g, _, model in chip_smoke.factor_fixtures_of(name):
            if g.split("/")[1] in chip_smoke.CAT_CARDS:
                out[g] = compile_graph(*model)
    return out


CAT_FIXTURES = _cat_fixtures()


@pytest.mark.parametrize("name", sorted(CAT_FIXTURES))
def test_replayed_order_equals_the_plain_version(name, monkeypatch):
    """Potentials first: the replay of the kernels' order == the plain
    version's potentials, bit for bit, on every step; then draws: a
    sweep whose potentials come from the replay == the plain sweep
    (values and counts), under the `row`/`cdf`, `tile`/`vec` and
    `row`/`sigmoid2` schedules."""
    cg = CAT_FIXTURES[name]
    rng = np.random.default_rng(len(name))
    w = torch.as_tensor(rng.choice(chip_smoke.DYADIC, cg.n_weights),
                        dtype=torch.float32)
    x0 = torch.as_tensor(np.asarray(cg.var_init), dtype=torch.int32)
    for m, d in (("row", "cdf"), ("tile", "vec"), ("row", "sigmoid2")):
        n = cg.n_colors
        sched = pig.default_schedule(cg)
        sched = pig.Schedule(colors=sched.colors, maps=(m,) * n,
                             draws=(d,) * n, upos=sched.upos)
        t = pig.build_tables(cg, sched, True, "cpu")
        plain = pig._padded_potentials
        for ci in range(t.n_steps):
            want = plain(t, ci, x0, w)
            got = replayed_potentials(t, ci, x0, w)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        runs = []
        for potentials in (plain, lambda t, ci, x, w, ext=None:
                           replayed_potentials(t, ci, x, w)):
            monkeypatch.setattr(pig, "_padded_potentials", potentials)
            x = x0.clone()
            counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32)
            for epoch in range(3):
                for ci in range(t.n_steps):
                    pig.color_step_reference(t, ci, x, counts, w, 977, epoch,
                                             epoch >= 1)
            runs.append((x, counts))
        monkeypatch.setattr(pig, "_padded_potentials", plain)
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
