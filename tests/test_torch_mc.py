"""The port's graph-sharded engine against the TPU's multi-chip engine,
on the CPU.

``MultiChipItemGridEngine`` of the JAX package runs here on simulated
CPU devices in interpret mode with its software PRNG (the 8-device
client of tests/conftest.py; meshes of fewer devices than that, as
tests/test_itemgrid_mc.py explains). The port's engine runs its plain
PyTorch versions (CPU tensors) under a schedule derived from the JAX
plan built for n_g shards. Inference weights are dyadic, and every
learning gradient here is a sum of integers, so values, counts, weights
and both chains must agree with tolerance 0.

The fixtures are large enough that every shard owns rows: a coin graph
of 3500 copies (affine colors: `tile` / `sigmoid2`, 1024 + 1024 + 1024
+ 428 rows per color at 4 shards) and an LF graph of 1600 copies
(general colors of 1600 and 3200 rows, `row` / `cdf`; the steps'
buffer widths differ, and the last shards own rows of one color only). Each JAX reference run happens once, in a
module-scope fixture.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import coin_model, lf_model
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops.gibbs import LearnParams as JaxLearnParams
from numbskull_tpu_torch.compile import compile_graph as port_compile_graph
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.models import ising_grid as port_ising_grid
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops import itemgrid_mc as mc
from numbskull_tpu_torch.ops.gibbs import LearnParams
from numbskull_tpu_torch.parallel import multihost
from test_torch_itemgrid import schedule_from_jax_plan
from test_torch_learn import learn_schedule_from_jax_plan


@pytest.fixture(autouse=True, scope="module")
def _sync_cpu_dispatch():
    """Concurrent interpret-mode meshes need synchronous CPU dispatch
    (tests/test_itemgrid_mc.py); restored afterwards."""
    prev = jax.config._read("jax_cpu_enable_async_dispatch")
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", prev)


def _coin():
    w, v, f, fm, dm, _ = coin_model(3500, 0.5, -0.25, 0.5, evidence=False,
                                    weight_init=(0.5, -0.25, 0.5),
                                    fixed=True)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _lf():
    w, v, f, fm, dm, _ = lf_model(0.5, [0.5, 0.25], copies=1600, seed=1)
    w["initialValue"] = [0.5, 0.25, -0.5]
    w["isFixed"] = True
    v["isEvidence"] = 0
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


GRAPHS = {"coin_affine": _coin, "lf_general": _lf}
RUN = dict(seed=1, burn=2, epochs=10)


class _JaxRuns:
    """JAX multi-chip engines and their runs, each computed once."""

    def __init__(self):
        self.cg, self.eng, self.res = {}, {}, {}

    def graph(self, name):
        if name not in self.cg:
            self.cg[name] = GRAPHS[name]()
        return self.cg[name]

    def engine(self, name, n_g):
        if (name, n_g) not in self.eng:
            self.eng[name, n_g] = jig.MultiChipItemGridEngine(
                self.graph(name), devices=jax.devices()[:n_g],
                interpret=True)
        return self.eng[name, n_g]

    def run(self, name, n_g, how):
        key = (name, n_g, how)
        if key not in self.res:
            x, c = getattr(self.engine(name, n_g), how)(**RUN)
            self.res[key] = (np.asarray(x), np.asarray(c))
        return self.res[key]


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns()


def _port_engine(jr, name, n_g, learn=False):
    cg = jr.graph(name)
    plan = jr.engine(name, n_g).plan
    sched = (learn_schedule_from_jax_plan if learn else
             schedule_from_jax_plan)(cg, plan)
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    return mc.MultiChipItemGridEngine(pcg, n_shards=n_g, device="cpu",
                                      schedule=sched)


@pytest.mark.parametrize("n_g", [2, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_run_and_emulated_match_jax_emulated(jax_runs, name, n_g):
    """Port run and run_emulated (plain) == JAX run_emulated, values and
    counts, tolerance 0; every shard owns rows of some step."""
    x_ref, c_ref = jax_runs.run(name, n_g, "run_emulated")
    eng = _port_engine(jax_runs, name, n_g)
    assert all(any(t.n_rows) for t in eng.tables)
    for x, c in (eng.run(**RUN), eng.run_emulated(**RUN)):
        np.testing.assert_array_equal(x.numpy(), x_ref)
        np.testing.assert_array_equal(c.numpy(), c_ref)
    aff = jax_runs.engine(name, n_g).plan.cmeta[:, 5] == 1
    assert aff.all() if name == "coin_affine" else not aff.any()


def test_run_matches_jax_concurrent_run(jax_runs):
    """Port run == the JAX engine's concurrent run (its per-color remote
    DMA exchange) at n_g = 2, and that run == its emulation."""
    x_ref, c_ref = jax_runs.run("coin_affine", 2, "run")
    x_emu, c_emu = jax_runs.run("coin_affine", 2, "run_emulated")
    np.testing.assert_array_equal(x_ref, x_emu)
    np.testing.assert_array_equal(c_ref, c_emu)
    x, c = _port_engine(jax_runs, "coin_affine", 2).run(**RUN)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(c.numpy(), c_ref)


def _learn_coin():
    w, v, f, fm, dm, _ = coin_model(1500, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


@pytest.mark.parametrize("lpk", [
    dict(regularization=2, reg_param=1e-4),
    dict(regularization=1, reg_param=0.01, truncation=3)],
    ids=["l2", "l1"])
def test_learn_two_shards_matches_jax(lpk):
    """Port learn at n_g = 2 == ``MultiChipItemGridEngine.learn(
    return_state=True)`` (interpret, 2 devices): weights, free and
    clamped chains, tolerance 0; the coin of test_mc_concurrent_learn_
    two_dev at 1500 copies, so both shards own rows. L1 runs too: the
    interpret-mode engine allows it at n_g > 1, and so does the port."""
    cg = _learn_coin()
    ref = jig.MultiChipItemGridEngine(cg, devices=jax.devices()[:2],
                                      interpret=True)
    args = dict(seed=7, burn=2, epochs=10, stepsize=0.05, decay=0.98)
    w_ref, x_ref, xe_ref = ref.learn(**args, lp=JaxLearnParams(**lpk),
                                     return_state=True)
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = mc.MultiChipItemGridEngine(
        pcg, n_shards=2, device="cpu",
        schedule=learn_schedule_from_jax_plan(cg, ref.plan))
    assert [t.n_rows for t in eng.tables] == [[1024, 1024], [476, 476]]
    w, x, xe = eng.learn(**args, lp=LearnParams(**lpk))
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(xe.numpy(), xe_ref)
    assert np.abs(w_ref).max() > 0.01


# ---- the port against itself -------------------------------------------

def _ising(n=48, m=48, frac=0.3, seed=1):
    w, v, f, fm, dm, _ = port_ising_grid(n, m, weight=0.25, fixed=False)
    rng = np.random.default_rng(seed)
    v["isEvidence"] = (rng.random(len(v)) < frac).astype(np.int8)
    v["initialValue"] = rng.integers(0, 2, len(v))
    return port_compile_graph(w, v, f, fm, domain_mask=dm)


@pytest.mark.parametrize("lpk", [
    dict(regularization=2, reg_param=1e-4),
    dict(regularization=1, reg_param=0.01, truncation=2,
         learn_non_evidence=True, grad_agg="sum")], ids=["l2", "l1_sum"])
def test_one_shard_equals_itemgrid_engine(lpk):
    """n_shards = 1 is ItemGridEngine: the same seed and salts, and the
    apply kernel's 0.0 + partial is the single-shard sum bit for bit."""
    cg = _ising()
    one = pig.ItemGridEngine(cg, device="cpu")
    eng = mc.MultiChipItemGridEngine(cg, n_shards=1, device="cpu")
    for a, b in zip(one.run(3, 2, 6), eng.run(3, 2, 6)):
        assert torch.equal(a, b)
    lp = LearnParams(**lpk)
    for a, b in zip(one.learn(5, 2, 4, 0.05, 0.98, lp),
                    eng.learn(5, 2, 4, 0.05, 0.98, lp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,epoch,ci,n_g,my", [
    (0, 0, 0, 1, 0), (3, 5, 1, 2, 1), (2 ** 31 - 1, 7, 2, 4, 3),
    (123456789, 9_000_000, 255, 4, 2), (2 ** 30 + 5, 65535, 3, 3, 2),
    (-5, 1 << 16, 1, 4, 3)])
def test_shard_seed_and_salt_arithmetic(seed, epoch, ci, n_g, my):
    """The shard streams wrap like the TPU kernel's int32 scalars:
    seed*977 + my, ((epoch*(C+1) + ci)*n_g + my)*65536, seed + my."""
    with np.errstate(over="ignore"):
        s = np.int32(seed)
        want_seed = np.int32(s * np.int32(977) + np.int32(my))
        base = np.int32(np.int32(epoch) * np.int32(pig.COLOR_MAX + 1) +
                        np.int32(ci))
        want_salt = np.int32(np.int32(base * np.int32(n_g) + np.int32(my))
                             * np.int32(65536))
        want_learn = np.int32(s + np.int32(my))
    assert pig.mc_seed977_of(seed, my) == int(want_seed)
    assert pig.mc_salt16_of(epoch, ci, n_g, my) == int(want_salt)
    assert pig.mc_learn_seed_of(seed, my) == int(want_learn)
    if n_g == 1:
        assert pig.mc_salt16_of(epoch, ci, 1, 0) == pig.salt16_of(epoch, ci)
        assert pig.mc_seed977_of(seed, 0) == pig.seed977_of(seed)


@pytest.mark.parametrize("n_g", [2, 3, 4])
def test_shard_tables_partition_the_sweep(n_g):
    """Each step's rows, items and arguments split over the shards; the
    draw positions are local; each shard's plain potentials equal the
    whole table's at its rows; the exchange rows follow the tables."""
    cg = _ising(80, 80)
    whole = pig.build_tables(cg, pig.default_schedule(cg), True, "cpu")
    eng = mc.MultiChipItemGridEngine(cg, n_shards=n_g, device="cpu")
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32)
    x = torch.as_tensor(cg.var_init, dtype=torch.int32)
    for ci in range(whole.n_steps):
        n = whole.n_rows[ci]
        nb = -(-n // (n_g * pig.RB))
        lo = whole.row0[ci]
        full_vid = whole.row_vid[lo:lo + n]
        full_pot = pig._padded_potentials(whole, ci, x, w)
        got = []
        for d, t in enumerate(eng.tables):
            a, m = t.row0[ci], t.n_rows[ci]
            vid = t.row_vid[a:a + m]
            upos = t.row_upos[a:a + m]
            assert m == 0 or (int(upos.min()) >= 0 and
                              int(upos.max()) < nb * pig.RB)
            assert torch.equal(vid, mc_rows(eng, ci, d))
            sel = t.row_index[ci]
            assert torch.equal(full_vid[sel], vid)
            assert torch.equal(pig._padded_potentials(t, ci, x, w),
                               full_pot[sel])
            got.append(vid)
        assert torch.equal(torch.sort(torch.cat(got))[0],
                           torch.sort(full_vid)[0])
        assert sum(len(t.item_index[ci]) for t in eng.tables) == \
            len(whole.item_index[ci])
    assert sum(int(t.arg_vid.numel()) for t in eng.tables) == \
        int(whole.arg_vid.numel())


def mc_rows(eng, ci, d):
    r = eng.rows[ci]
    return r.vid[r.offs_host[d]:r.offs_host[d + 1]]


def test_exchange_miniature():
    """The miniature of test_exchange_color_real_interpret: 2 shards own
    one 1024-value block each of a 2048-value array; each replica holds
    only its own block; after the unpack both hold the whole array."""
    rows = mc.StepRows(vid=torch.arange(2048, dtype=torch.int32),
                       offs=torch.tensor([0, 1024, 2048], dtype=torch.int32),
                       offs_host=[0, 1024, 2048], rs=1024)
    payload = torch.stack([torch.full((1024,), 5, dtype=torch.int32),
                           torch.full((1024,), 9, dtype=torch.int32)])
    xs = torch.zeros((2, 2048), dtype=torch.int32)
    xs[0, :1024] = 5
    xs[1, 1024:] = 9
    before = mc.EXCHANGE_LAUNCHES
    for d in range(2):
        mc.unpack(rows, payload, xs[d], None, d)
    want = torch.cat([torch.full((1024,), 5), torch.full((1024,), 9)])
    assert torch.equal(xs[0], want.int()) and torch.equal(xs[1], want.int())
    assert mc.EXCHANGE_LAUNCHES == before        # CPU runs never launch
    xe = torch.zeros(2048, dtype=torch.int32)
    wide = torch.cat([payload, payload + 1], dim=1)
    mc.unpack(rows, wide, xs[0].clone(), xe, 0)
    assert torch.equal(xe[1024:], torch.full((1024,), 10, dtype=torch.int32))
    assert int(xe[:1024].abs().sum()) == 0       # own rows left alone
    with pytest.raises(ValueError):
        mc.unpack(rows, payload, torch.zeros(2048, dtype=torch.int32,
                                             device="meta"))


def test_gloo_two_processes_equal_in_process(tmp_path):
    """Two CPU processes over a gloo group (file store) == in-process
    n_shards = 2, bit for bit, for run (values, summed counts) and
    learn (weights, both chains), on both ranks."""
    from _torch_mc_worker import run_shard
    cg = _ising()
    run_args = (3, 2, 6)
    learn_args = (4, 1, 3, 0.05, 0.98)
    lp = LearnParams(regularization=1, reg_param=0.01, truncation=2)
    eng = mc.MultiChipItemGridEngine(cg, n_shards=2, device="cpu")
    assert all(any(t.n_rows) for t in eng.tables)
    x, counts = eng.run(*run_args)
    w, xl, xel = eng.learn(*learn_args, lp=lp)
    multihost.spawn(run_shard, 2, (cg, run_args, learn_args, lp,
                                   str(tmp_path)), backend="gloo",
                    timeout=120)
    for r in range(2):
        got = torch.load(tmp_path / ("rank%d.pt" % r))
        assert got["shards"] == (r,) and got["n_g"] == 2
        for key, want in (("x", x), ("counts", counts), ("w", w),
                          ("xl", xl), ("xel", xel)):
            assert torch.equal(got[key], want), (r, key)


def test_engine_arguments():
    """Shard counts and groups: n_shards None is one shard; a group
    fixes the count; run_emulated needs every shard in this process;
    marginals divide by the epochs."""
    cg = _ising(8, 8)
    assert mc.MultiChipItemGridEngine(cg, device="cpu").n_g == 1
    with pytest.raises(ValueError):
        mc.MultiChipItemGridEngine(cg, n_shards=0, device="cpu")
    eng = mc.MultiChipItemGridEngine(cg, n_shards=2, device="cpu")
    _, counts = eng.run(1, 0, 4)
    assert torch.equal(eng.marginals(counts, 4),
                       counts.double() / 4.0)
    with pytest.raises(ValueError, match="sample_evidence"):
        mc.MultiChipItemGridEngine(cg, sample_evidence=False,
                                   device="cpu").learn(1, 0, 1, 0.1)


def test_engines_default_to_the_card():
    """ItemGridEngine and MultiChipItemGridEngine run on ``cuda`` unless
    the caller asks for the CPU."""
    for cls in (pig.ItemGridEngine, mc.MultiChipItemGridEngine):
        assert inspect.signature(cls).parameters["device"].default == \
            "cuda"
    if not torch.cuda.is_available():
        cg = _ising(8, 8)
        with pytest.raises((RuntimeError, AssertionError)):
            pig.ItemGridEngine(cg)
        with pytest.raises((RuntimeError, AssertionError)):
            mc.MultiChipItemGridEngine(cg, n_shards=2)


def test_partial_of_an_empty_step_is_zero():
    """A shard with no rows in a step contributes a zero partial and
    launches nothing."""
    cg = _ising(40, 40)
    eng = mc.MultiChipItemGridEngine(cg, n_shards=3, device="cpu")
    lt = eng.learn_tables()[2]
    assert not any(lt.sweep.n_rows)
    W = cg.n_weights
    part = torch.full((2 * W,), 7, dtype=torch.int32)
    x = torch.as_tensor(cg.var_init, dtype=torch.int32)
    hs = pig.learn_step_of(LearnParams(), 0.1, 1.0, 0)
    before = pig.LEARN_LAUNCHES
    pig.learn_color_partial(lt, 0, x, x.clone(), torch.zeros(W), 1, 0, hs,
                            part)
    assert int(part.abs().sum()) == 0 and pig.LEARN_LAUNCHES == before
