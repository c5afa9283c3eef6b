"""The sweep and learn kernels' packed tables and the item kernel's tiles,
on the CPU.

``ops/itemgrid.build_tables`` packs every item into 12 B (the CSR offset
of its first argument, its weight, and one word of ftype, dense and the
two slots) and every argument into 8 B (the variable, ``~vid`` for the
row's own, and one word of eq and card). The kernels cannot run here,
so these tests hold the packing itself: each table, unpacked, equals the
per-field arrays taken straight from the compiled plans, on the graphs
that ``chip_smoke.py`` holds the kernels to on the card (at smaller
sizes); a value beyond its field raises ``EnvelopeError``, on which the
CLI runs the graph on ``GibbsEngine`` as for every other refusal; and
the item kernel's walk over tiles and chunks (written out below from
``csrc/itemgrid_sweep.cu``), with the tile the wrapper picks, reads every
row and item of a step exactly once. The kernels themselves are held to
the plain version on the card by ``chip_smoke.py`` (phase 2).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from numbskull_tpu import numbskull as jax_cli
from numbskull_tpu_torch import dataloading as port_dl
from numbskull_tpu_torch import models as M
from numbskull_tpu_torch import numbskull as port_cli
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import GibbsEngine

from _torch_threads import cap_threads

cap_threads()


def _cg(model, **kw):
    w, v, f, fm, dm, _ = model
    return compile_graph(w, v, f, fm, domain_mask=dm, **kw)


def _with_evidence(model, frac, seed):
    w, v, f, fm, dm, e = model
    rng = np.random.default_rng(seed)
    v["isEvidence"] = (rng.random(len(v)) < frac).astype(np.int8)
    v["initialValue"] = rng.integers(0, 1 << 30, len(v)) % v["cardinality"]
    return w, v, f, fm, dm, e


def _fixtures():
    """The graph families of chip_smoke.py's phase 2, smaller."""
    ising = M.ising_grid(16, 16, weight=0.25)
    ising[1]["isEvidence"][::7] = 1
    lf = M.lf_model(0.5, [0.5, 0.25, 0.75], copies=200, seed=1)
    out = {"coin": _cg(M.coin_model(64, evidence=False,
                                    weight_init=(0.5, -0.25, 0.5),
                                    fixed=True)),
           "ising16_clamped": _cg(ising),
           "lf_card3": _cg(lf)}
    for card in (20, 64, 128):
        out["potts8_card%d" % card] = _cg(
            M.potts_grid(8, 8, card=card, weight=0.25),
            color_hint=M.ising_color_hint(8, 8))
    out["voting_degree50"] = _cg(M.voting_grouped(1000, 50, weight=0.5,
                                                  evidence_frac=0.1))
    out["ising16_max_colors1"] = _cg(_with_evidence(M.ising_grid(
        16, 16, weight=0.25, fixed=False), 0.3, 2), max_colors=1)
    return out


FIXTURES = _fixtures()


def _unpacked_from_plans(t):
    """Today's per-field tables of ``t``, taken from its plans: every
    step's items (``item_index``) with their fields, and their arguments
    in item order."""
    cols = {k: [] for k in ("ftype", "wid", "arity", "dense", "d1", "d2",
                            "vid", "eq", "card", "subst")}
    for p, iv in zip(t.plans, t.item_index):
        arity = np.asarray(p.it_arity)[iv].astype(np.int64)
        amask = np.arange(p.it_args_vid.shape[1])[None, :] < arity[:, None]
        for k, a in (("ftype", p.it_ftype), ("wid", p.it_wid),
                     ("dense", p.it_dense), ("d1", p.it_d1),
                     ("d2", p.it_d2)):
            cols[k].append(np.asarray(a)[iv].astype(np.int64))
        cols["arity"].append(arity)
        for k, a in (("vid", p.it_args_vid), ("eq", p.it_args_eq),
                     ("card", p.it_args_card), ("subst", p.it_subst)):
            cols[k].append(np.asarray(a)[iv][amask].astype(np.int64))
    return {k: np.concatenate(v) if v else np.zeros(0, np.int64)
            for k, v in cols.items()}


def _check_unpacks(t):
    want = _unpacked_from_plans(t)
    got = {"ftype": t.it_ftype, "wid": t.it_wid, "arity": t.it_arity,
           "dense": t.it_dense, "d1": t.it_d1, "d2": t.it_d2,
           "eq": t.arg_eq, "card": t.arg_card, "subst": t.arg_subst,
           "vid": torch.where(t.arg_vid < 0, ~t.arg_vid, t.arg_vid)}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy().astype(np.int64), want[k],
                                      err_msg=k)
    assert t.it_arg.dtype == torch.int32 and t.it_meta.dtype == torch.int32
    assert t.arg_vid.dtype == torch.int32 and t.arg_ec.dtype == torch.int32
    np.testing.assert_array_equal(
        t.it_arg.numpy(), np.concatenate(([0], np.cumsum(want["arity"]))))
    for n, p, iv, shape in zip(t.n_rows, t.plans, t.item_index,
                               t.item_shape):
        arity = np.asarray(p.it_arity)[iv]
        if t.kmax > 2:
            assert shape == (pig.cat_tile_rows(n, len(iv), t.kmax), 1, 0)
            continue
        lanes = pig.sweep_lanes(len(iv), int(arity.sum()))
        assert shape == (pig.sweep_tile_rows(n, len(iv), lanes), lanes,
                         int(pig.fast_step(np.asarray(p.it_ftype)[iv],
                                           arity)))
    # 12 B an item (it_arg's one extra entry aside) and 8 B an argument
    n_items, n_args = len(want["wid"]), len(want["vid"])
    item_bytes = sum(a.numel() * a.element_size()
                     for a in (t.it_arg, t.it_wid, t.it_meta))
    arg_bytes = sum(a.numel() * a.element_size()
                    for a in (t.arg_vid, t.arg_ec))
    assert item_bytes == 12 * n_items + 4 and arg_bytes == 8 * n_args


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_packed_tables_unpack_to_the_plans_fields(name):
    """Every fixture: the packed tables, unpacked, equal the per-field
    arrays of the plans, exactly (exact integer fields: no tolerance)."""
    cg = FIXTURES[name]
    eng = pig.ItemGridEngine(cg, device="cpu")
    _check_unpacks(eng.tables)
    if name == "ising16_max_colors1":
        assert eng.tables.conflict == [True]
    if name == "voting_degree50":
        assert int(eng.tables.it_arity.max()) == 51
    # EQUAL, ISTRUE, AND graphs run the fast item kernel, LF does not
    fast = {"coin": True, "ising16_clamped": True, "voting_degree50": True,
            "ising16_max_colors1": True, "lf_card3": False}
    if name in fast:
        assert [s[2] for s in eng.tables.item_shape] == \
            [fast[name]] * eng.tables.n_steps


def test_learn_tables_share_the_packed_tables():
    """Learning reads the sweep's tables: one copy of each, no other
    item or argument table."""
    cg = _cg(_with_evidence(M.ising_grid(16, 16, weight=0.25, fixed=False),
                            0.3, 1))
    eng = pig.ItemGridEngine(cg, device="cpu")
    lt = eng.learn_tables()
    for name, _ in pig._TABLE_FIELDS:
        assert getattr(lt.sweep, name) is getattr(eng.tables, name)


def test_shard_tables_are_packed_the_same_way():
    """A 4-shard split (build_tables with ``shard``): each shard's tables
    unpack to its plans' fields, and the shards' arguments add up to the
    whole graph's."""
    cg = _cg(M.ising_grid(128, 128, weight=0.25),
             color_hint=M.ising_color_hint(128, 128))
    sched = pig.default_schedule(cg)
    whole = pig.build_tables(cg, sched, True, "cpu")
    shards = [pig.build_tables(cg, sched, True, "cpu", shard=(d, 4))
              for d in range(4)]
    for t in shards:
        assert all(n > 0 for n in t.n_rows)
        _check_unpacks(t)
    assert sum(int(t.arg_vid.numel()) for t in shards) == \
        int(whole.arg_vid.numel())
    assert sum(int(t.it_meta.numel()) for t in shards) == \
        int(whole.it_meta.numel())


@pytest.mark.parametrize("field,kw", [
    ("factor function code", dict(ftype=[31])),
    ("factor function code", dict(ftype=[-2])),
    ("slot d1", dict(d1=[256])),
    ("slot d1", dict(d1=[-1])),
    ("slot d2", dict(d2=[300])),
])
def test_pack_items_refuses_values_beyond_their_fields(field, kw):
    args = dict(ftype=[3], dense=[True], d1=[0], d2=[1])
    args.update(kw)
    with pytest.raises(pig.EnvelopeError, match=field):
        pig.pack_items(**args)


@pytest.mark.parametrize("field,kw", [
    ("argument eq", dict(eq=[1 << 15])),
    ("argument eq", dict(eq=[-(1 << 15) - 1])),
    ("argument cardinality", dict(card=[1 << 16])),
    ("argument variable", dict(vid=[-1])),
])
def test_pack_args_refuses_values_beyond_their_fields(field, kw):
    args = dict(vid=[5], subst=[False], eq=[0], card=[2])
    args.update(kw)
    with pytest.raises(pig.EnvelopeError, match=field):
        pig.pack_args(**args)


def test_pack_round_trips_the_field_edges():
    """The largest and smallest value of every field packs and unpacks
    to itself."""
    meta = torch.as_tensor(pig.pack_items([-1, 30, 3], [False, True, True],
                                          [0, 255, 7], [255, 0, 7]))
    t = pig.SweepTables.__new__(pig.SweepTables)
    t.it_meta = meta
    assert t.it_ftype.tolist() == [-1, 30, 3]
    assert t.it_dense.tolist() == [0, 1, 1]
    assert t.it_d1.tolist() == [0, 255, 7]
    assert t.it_d2.tolist() == [255, 0, 7]
    ref, ec = pig.pack_args([0, 2 ** 31 - 1, 9], [True, False, True],
                            [-(1 << 15), (1 << 15) - 1, 0],
                            [0, (1 << 16) - 1, 2])
    t.arg_vid, t.arg_ec = torch.as_tensor(ref), torch.as_tensor(ec)
    assert t.arg_subst.tolist() == [1, 0, 1]
    assert torch.where(t.arg_vid < 0, ~t.arg_vid, t.arg_vid).tolist() == \
        [0, 2 ** 31 - 1, 9]
    assert t.arg_eq.tolist() == [-(1 << 15), (1 << 15) - 1, 0]
    assert t.arg_card.tolist() == [0, (1 << 16) - 1, 2]


def _coin_dir(path, equal_to):
    """The 400-variable coin graph with every fmap entry's
    dense_equal_to set to ``equal_to`` (its ISTRUE and EQUAL factors on
    dense boolean variables read neither eq nor the slots, so the
    distribution is the coin's)."""
    w, v, f, fm, _, _ = M.coin_model(200, 0.8, -0.5, 0.4, evidence=True,
                                     fixed=False, seed=3)
    fm["dense_equal_to"] = equal_to
    port_dl.write_factor_graph_files(path, w, v, f, fm)
    return path


def test_value_beyond_a_field_falls_back_to_the_tensor_op_engine(tmp_path):
    """An eq (and a slot) beyond its field: the kernel engine refuses the
    graph with EnvelopeError, and the CLI (-l 20 -i 200 -b 10 under --engine
    itemgrid) warns, counts one fallback, learns and infers on
    GibbsEngine and writes both files. Its marginals are within 0.1 of
    the JAX CLI's on average and its weights within 0.05 (measured 0.040
    and 0.0021 apart: two chains of 200 epochs on 400 variables after 20
    learning epochs, from different streams)."""
    src = _coin_dir(str(tmp_path / "coin"), 40000)
    w, v, f, fm, dm, _ = M.coin_model(200, 0.8, -0.5, 0.4, evidence=True,
                                      fixed=False, seed=3)
    fm["dense_equal_to"] = 40000
    with pytest.raises(pig.EnvelopeError, match="beyond its field"):
        pig.ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                           device="cpu")
    args = [src, "-l", "20", "-i", "200", "-b", "10", "-q"]
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    before = metrics.snapshot()["counters"].get("engine.fallbacks", 0.0)
    with pytest.warns(UserWarning, match="--engine itemgrid unavailable "
                      "for this graph.*beyond its field"):
        ns = port_cli.main(args + ["-o", out_p, "--device", "cpu",
                                   "--engine", "itemgrid"])
    jax_cli.main(args + ["-o", out_j])
    assert metrics.snapshot()["counters"]["engine.fallbacks"] == before + 1
    eng = ns.getFactorGraph().engine(True)
    assert isinstance(eng, GibbsEngine) and eng.device.type == "cpu"
    p = np.loadtxt(os.path.join(out_p, "inference_result.out.text"),
                   ndmin=2)
    j = np.loadtxt(os.path.join(out_j, "inference_result.out.text"),
                   ndmin=2)
    np.testing.assert_array_equal(p[:, :2], j[:, :2])
    assert np.abs(p[:, 2] - j[:, 2]).mean() < 0.1
    wp = np.loadtxt(os.path.join(out_p, "inference_result.out.weights.text"),
                    ndmin=2)[:, 1]
    wj = np.loadtxt(os.path.join(out_j, "inference_result.out.weights.text"),
                    ndmin=2)[:, 1]
    assert np.abs(wp - wj).max() < 0.05


def test_graph_within_the_fields_runs_on_the_kernel_engine(tmp_path):
    """The same graph with dense_equal_to 0 stays on the kernel engine:
    no warning, no fallback."""
    src = _coin_dir(str(tmp_path / "coin"), 0)
    before = metrics.snapshot()["counters"].get("engine.fallbacks", 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ns = port_cli.main([src, "-i", "5", "-q", "-o", str(tmp_path / "o"),
                            "--device", "cpu", "--engine", "itemgrid"])
    assert metrics.snapshot()["counters"].get("engine.fallbacks", 0.0) == \
        before
    assert isinstance(ns.getFactorGraph().engine(True), pig.ItemGridEngine)


def kernel_walk(row_item, it_arg, row0, n_rows, tile_rows, staged):
    """sweep_item_kernel's index arithmetic (csrc/itemgrid_sweep.cu) for
    one step: block b takes rows [b * tile_rows, ...) and walks their
    items in chunks of at most SWEEP_CHUNK items and, ``staged`` (a fast
    step at one lane an item), at most SWEEP_ARG_CHUNK arguments; row
    thread r adds, chunk after
    chunk, the part of its items that the chunk holds. Returns how often
    each row was drawn, how often each item was evaluated, each row's
    items in the order they were added, and the staged chunks' argument
    counts."""
    drawn = np.zeros(n_rows, np.int64)
    item0, item1 = int(row_item[row0]), int(row_item[row0 + n_rows])
    evaluated = np.zeros(item1 - item0, np.int64)
    added = [[] for _ in range(n_rows)]
    staged_args = []
    for b in range(-(-n_rows // tile_rows)):
        i0 = b * tile_rows
        nr = min(tile_rows, n_rows - i0)
        assert 1 <= nr <= pig.SWEEP_THREADS
        r0 = row0 + i0
        c0, t1 = int(row_item[r0]), int(row_item[r0 + nr])
        while c0 < t1:
            c1 = min(t1, c0 + pig.SWEEP_CHUNK)
            a0 = it_arg[c0]
            if staged and it_arg[c1] - a0 > pig.SWEEP_ARG_CHUNK:
                c1 = max([c for c in range(c0 + 2, c1 + 1)
                          if it_arg[c] - a0 <= pig.SWEEP_ARG_CHUNK],
                         default=c0 + 1)
            if staged and it_arg[c1] - a0 <= pig.SWEEP_ARG_CHUNK:
                staged_args.append(it_arg[c1] - a0)
            evaluated[c0 - item0:c1 - item0] += 1
            for tid in range(nr):
                lo = max(int(row_item[r0 + tid]), c0)
                hi = min(int(row_item[r0 + tid + 1]), c1)
                added[i0 + tid].extend(range(lo, hi))
            c0 = c1
        drawn[i0:i0 + nr] += 1
    return drawn, evaluated, added, staged_args


def _steps():
    """(name, items of each row, arity of each item): steps of 1, 127,
    128, 129 and 4096 rows (0 to 9 items a row, arity 1 to 4), one with
    a row longer than a chunk, one of wide one-item rows, one with an
    item of more arguments than a staged chunk holds, and empty rows at
    both ends."""
    rng = np.random.default_rng(4)
    out = []
    for n in (1, 127, 128, 129, 4096):
        counts = rng.integers(0, 10, n)
        out.append(("%d rows" % n, counts,
                    rng.integers(1, 5, int(counts.sum()))))
    counts = rng.integers(0, 5, 300)
    counts[77] = 3 * pig.SWEEP_CHUNK + 5
    out.append(("a row of %d items" % counts[77], counts,
                rng.integers(1, 4, int(counts.sum()))))
    out.append(("one item of arity 51 a row", np.ones(5000, np.int64),
                np.full(5000, 51)))
    arity = rng.integers(1, 5, 40)
    arity[17] = pig.SWEEP_ARG_CHUNK + 300
    out.append(("an item of %d arguments" % arity[17],
                np.full(10, 4), arity))
    out.append(("empty ends", np.array([0, 4, 4, 0]),
                rng.integers(1, 5, 8)))
    return out


@pytest.mark.parametrize("name,counts,arity", _steps(),
                         ids=[n for n, _, _ in _steps()])
def test_item_kernel_tiles_cover_every_row_and_item_once(name, counts,
                                                         arity):
    """With the tile rows and lanes that the wrapper picks, staged (where
    fast_step allows it) or not, every row is drawn once and every item
    is evaluated once, each row adds exactly its own items, in item
    order, and a staged chunk holds no more argument values than the
    kernel's shared memory."""
    first = np.array([3, 1, 2])
    row_item = np.concatenate(([0], np.cumsum(np.concatenate((first,
                                                              counts)))))
    it_arg = np.concatenate(([0], np.cumsum(np.concatenate((
        np.ones(first.sum(), np.int64), arity)))))
    row0, n_rows = len(first), len(counts)
    n_items, n_args = int(counts.sum()), int(arity.sum())
    lanes = pig.sweep_lanes(n_items, n_args)
    tr = pig.sweep_tile_rows(n_rows, n_items, lanes)
    assert tr & (tr - 1) == 0 and 1 <= tr <= pig.SWEEP_THREADS
    can_stage = pig.fast_step(np.full(len(arity), 3), arity)
    assert can_stage == (arity.max() <= pig.SWEEP_ARG_CHUNK)
    for staged in {False, can_stage}:
        drawn, evaluated, added, staged_args = kernel_walk(
            row_item, it_arg, row0, n_rows, tr, staged)
        assert (drawn == 1).all() and (evaluated == 1).all()
        for i in range(n_rows):
            assert added[i] == list(range(row_item[row0 + i],
                                          row_item[row0 + i + 1]))
        assert all(1 <= a <= pig.SWEEP_ARG_CHUNK for a in staged_args)


def test_tile_and_lane_choice():
    """The choice on the main path's shapes: the 1M and 33.5M Ising
    colors take 128-row tiles, one lane an item; grouped voting at
    degree 50 (about 4 k rows a color, one item of arity 51 each) takes
    32 lanes an item and tiles of 4 rows, about a thousand blocks; no
    step gets fewer blocks than it has rows / 128."""
    assert pig.sweep_lanes(2097152, 4194304) == 1
    assert pig.sweep_tile_rows(524288, 2097152, 1) == 128
    assert pig.sweep_tile_rows(16777216, 67108864, 1) == 128
    lanes = pig.sweep_lanes(4116, 4116 * 51)
    assert lanes == 32
    assert pig.sweep_tile_rows(4116, 4116, lanes) == 4
    assert pig.sweep_lanes(18000, 18000 * 11) == 8
    for n_rows in (1, 5, 127, 1000, 4116, 70000, 524288):
        for per_row in (1, 4, 50):
            tr = pig.sweep_tile_rows(n_rows, n_rows * per_row, 1)
            assert -(-n_rows // tr) >= -(-n_rows // pig.SWEEP_THREADS)
