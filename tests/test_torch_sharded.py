"""The port's (chains, graph) mesh engine (numbskull_tpu_torch/parallel/
mesh.py and sharded.py) in one process on the CPU, mirroring
tests/test_sharded.py: marginals against exact joints, learning against
the generating weights, and against the JAX ``ShardedGibbsEngine`` on
the conftest's 8-device mesh statistically (torch Philox and JAX
threefry streams differ). The rest is exact: with dyadic weights every
potential sum is exact in any order, so a (chains, graph) shape must
give chain c the values and tallies of ``GibbsEngine`` seeded with
``chain_seed(seed, c)``, and graph sharding must not change learning.
Graphs are replicated (``models.replicate``) where the JAX tests run
more epochs on one copy.
"""

import functools
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from numbskull_tpu import golden
from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import replicate as jax_replicate
from numbskull_tpu.parallel.mesh import make_mesh as jax_make_mesh
from numbskull_tpu.parallel.sharded import (
    ShardedGibbsEngine as JaxShardedGibbsEngine,
)
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import (coin_exact_marginal, coin_model,
                                        ising_color_hint, ising_grid,
                                        lf_model, pool_chain_counts,
                                        replicate_graph)
from numbskull_tpu_torch.ops.gibbs import GibbsEngine, LearnParams
from numbskull_tpu_torch.parallel import make_mesh
from numbskull_tpu_torch.parallel.sharded import (ShardedGibbsEngine,
                                                  chain_seed, shard_items)

from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(cg, shape):
    return ShardedGibbsEngine(cg, make_mesh(*shape, device="cpu"))


def _marginals(cg, shape, epochs, burn=20, seed=0):
    eng = _engine(cg, shape)
    st = eng.inference(eng.init_state(), seed, epochs, burn=burn)
    return eng.marginals(st, epochs)


def _coin(copies, a, b, c):
    w, v, f, fm, dm, _ = coin_model(copies, a, b, c, evidence=False,
                                    weight_init=(a, b, c), fixed=True)
    return compile_graph(w, v, f, fm, domain_mask=dm)


def _ising_copies(n, weight, copies):
    """``copies`` disjoint n x n Ising grids (checkerboard colors) and
    the model of one."""
    model = ising_grid(n, n, weight=weight)
    w, v, f, fm, dm, _ = replicate_graph(model, copies)
    hint = np.tile(ising_color_hint(n, n), copies)
    return compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint), \
        model


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1), (4, 2)])
def test_mesh_shapes_match_exact(shape):
    """Same exact coin marginals for any (chains, graph) mesh shape."""
    a, b, c = 0.4, -0.3, 0.6
    marg = _marginals(_coin(100, a, b, c), shape, epochs=160 // shape[0])
    p = coin_exact_marginal(a, b, c)
    assert marg[0::2, 1].mean() == pytest.approx(p[2] + p[3], abs=0.04)
    assert marg[1::2, 1].mean() == pytest.approx(p[1] + p[3], abs=0.04)


def test_graph_sharding_matches_exact_ising():
    """Graph-sharded sweep = exact chromatic Gibbs (no halo staleness):
    a 3x3 Ising at (2, 4), pooled over 40 copies."""
    cg, (w, v, f, fm, _, _) = _ising_copies(3, 0.4, 40)
    marg = pool_chain_counts(_marginals(cg, (2, 4), epochs=150), 40)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    assert np.abs(marg[:, 1] - exact[:, 1]).max() < 0.05


def test_chains_reduce_variance():
    """8 chains of N epochs ~ 1 chain of 8N epochs."""
    marg = _marginals(_coin(25, 0.2, 0.2, 0.2), (8, 1), epochs=100)
    p = coin_exact_marginal(0.2, 0.2, 0.2)
    assert marg[0::2, 1].mean() == pytest.approx(p[2] + p[3], abs=0.03)


def test_distributed_learning_recovers_weights():
    """Gradients summed over graph and averaged over chains recover the
    coin weights (the reference's master/minion dw summation,
    numbskull_master.py:223-224)."""
    a, b, c = 0.8, -0.5, 0.4
    w, v, f, fm, dm, _ = coin_model(2000, a, b, c, evidence=True,
                                    weight_init=(0, 0, 0), fixed=False,
                                    seed=3)
    eng = _engine(compile_graph(w, v, f, fm, domain_mask=dm), (2, 4))
    st = eng.learn(eng.init_state(), 1, epochs=100, stepsize=0.1,
                   decay=0.99, burn=10,
                   lp=LearnParams(regularization=2, reg_param=1e-4))
    got = st.weight_value.numpy()
    assert got[0] == pytest.approx(a, abs=0.15)
    assert got[1] == pytest.approx(b, abs=0.15)
    assert got[2] == pytest.approx(c, abs=0.15)


def test_sharded_vs_single_engine_statistics():
    """The mesh engine at (1, 8) and GibbsEngine agree statistically on
    a 4x4 Ising (40 copies)."""
    cg, _ = _ising_copies(4, 0.3, 40)
    sharded = pool_chain_counts(_marginals(cg, (1, 8), epochs=150), 40)
    eng = GibbsEngine(cg, device="cpu")
    st = eng.inference(eng.init_state(), 5, 150, burn=20)
    single = pool_chain_counts(eng.marginals(st, 150), 40)
    assert np.abs(sharded[:, 1] - single[:, 1]).max() < 0.05


def test_matches_jax_sharded_engine():
    """The port and the JAX ShardedGibbsEngine on the same 4x4 Ising
    (20 copies) at (2, 4): pooled marginals within 0.05 (the bound of
    tests/test_sharded.py's statistical checks)."""
    cg, model = _ising_copies(4, 0.3, 20)
    port = pool_chain_counts(_marginals(cg, (2, 4), epochs=150), 20)
    w, v, f, fm, dm, _ = jax_replicate.replicate_graph(model, 20)
    jcg = jax_compile_graph(w, v, f, fm, domain_mask=dm,
                            color_hint=np.tile(ising_color_hint(4, 4), 20))
    je = JaxShardedGibbsEngine(jcg, jax_make_mesh(2, 4))
    st = je.inference(je.init_state(), jax.random.PRNGKey(0), 1000,
                      burn=50)
    ref = jax_replicate.pool_chain_counts(je.marginals(st, 1000), 20)
    assert np.abs(port[:, 1] - ref[:, 1]).max() < 0.05


# ---- exact checks (dyadic weights) ----------------------------------------

@functools.cache
def _dyadic_graph(name):
    """``ising``: a 10x10 Ising with a learnable weight 0.25 and 30 %
    evidence; ``lf``: an LF graph (cardinality 3) with dyadic weights
    and its evidence."""
    if name == "lf":
        w, v, f, fm, dm, _ = lf_model(0.5, [0.8, 0.6, 0.7], copies=30,
                                      seed=1, weight_init=0.5,
                                      prior_init=0.25)
        return compile_graph(w, v, f, fm, domain_mask=dm)
    w, v, f, fm, dm, _ = ising_grid(10, 10, weight=0.25, fixed=False)
    rng = np.random.default_rng(4)
    ev = rng.random(len(v)) < 0.3
    v["isEvidence"] = ev.astype(v["isEvidence"].dtype)
    v["initialValue"] = np.where(ev, rng.integers(0, 2, len(v)), 0)
    return compile_graph(w, v, f, fm, domain_mask=dm,
                         color_hint=ising_color_hint(10, 10))


#: learning whose weights stay dyadic: summed gradients, a step of 1/4,
#: an L1 step of 1/16 per truncation
DYADIC_L1 = LearnParams(regularization=1, reg_param=0.25, truncation=2,
                        grad_agg="sum")


FIELDS = ("var_value", "var_value_evid", "count", "weight_value")


def _chain_equals(single, st, c):
    """GibbsEngine's state ``single`` == chain c of the mesh state."""
    return all(torch.equal(getattr(single, n), getattr(st, n)[c])
               for n in FIELDS[:3]) and \
        torch.equal(single.weight_value, st.weight_value)


def _equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n in FIELDS)


@pytest.mark.parametrize("graph", ["ising", "lf"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 3), (1, 4), (2, 1),
                                   (2, 2), (2, 3), (3, 2)])
def test_shapes_equal_gibbs_engine_bit_for_bit(graph, shape):
    """Chain c of any shape == GibbsEngine seeded chain_seed(seed, c)
    (inference, 2 burn-in + 4 tallied epochs from epoch offset 3); one
    chain learning under L2 == GibbsEngine (weights and both chains);
    graph sharding leaves L1 learning (C, G) == (C, 1)."""
    cg = _dyadic_graph(graph)
    eng = _engine(cg, shape)
    g = GibbsEngine(cg, device="cpu")
    st = eng.inference(eng.init_state(), 11, 4, burn=2, epoch_offset=3)
    for c in range(shape[0]):
        ref = g.inference(g.init_state(), chain_seed(11, c), 4, burn=2,
                          epoch_offset=3)
        assert _chain_equals(ref, st, c), c
    l2 = LearnParams(regularization=2, reg_param=0.01)
    if shape[0] == 1:
        ls = eng.learn(eng.init_state(), 5, 3, 0.1, decay=0.9, burn=1,
                       lp=l2)
        ref = g.learn(g.init_state(), chain_seed(5, 0), 3, 0.1, decay=0.9,
                      burn=1, lp=l2)
        assert _chain_equals(ref, ls, 0)
    one = _engine(cg, (shape[0], 1))
    ref = one.learn(one.init_state(), 6, 3, 0.25, burn=1, lp=DYADIC_L1)
    got = eng.learn(eng.init_state(), 6, 3, 0.25, burn=1, lp=DYADIC_L1)
    assert _equal(got, ref)


def test_chunks_compose_and_learning_moves_the_weights():
    """Inference in two chunks that pass ``epoch_offset`` == one call;
    L1 learning with truncation moves the weights off their start, the
    same on every chain (one weight vector for the mesh)."""
    cg = _dyadic_graph("lf")
    eng = _engine(cg, (2, 2))
    whole = eng.inference(eng.init_state(), 3, 6, burn=2)
    part = eng.inference(eng.init_state(), 3, 2, burn=2)
    part = eng.inference(part, 3, 4, epoch_offset=2)
    assert _equal(whole, part)
    st = eng.learn(eng.init_state(), 2, 4, 0.25, burn=1, lp=DYADIC_L1)
    assert st.weight_value.shape == (cg.n_weights,)
    assert not torch.equal(st.weight_value, eng.init_state().weight_value)


def test_shard_items_split_like_jax():
    """Each shard's items are the JAX engine's ``_shard_items`` shard
    without its pad items (contiguous, item order kept)."""
    from numbskull_tpu.parallel.sharded import _shard_items
    for n, G in ((10, 4), (8, 8), (3, 4), (0, 2), (9, 3), (1000, 3)):
        ref = np.asarray(_shard_items({"it_ftype": np.arange(n),
                                       "cv_card": np.zeros(1)}, G)
                         ["it_ftype"])
        for s in range(G):
            assert np.array_equal(shard_items(n, G, s),
                                  ref[s][ref[s] >= 0]), (n, G, s)


def test_make_mesh_in_process():
    """In process: n_graph None is 1; every chain and shard here; the
    JAX mesh's axis names; shapes below 1 refused."""
    m = make_mesh(3, device="cpu")
    assert (m.n_chains, m.n_graph, m.chains, m.shards) == \
        (3, 1, (0, 1, 2), (0,))
    assert m.shape == {"chains": 3, "graph": 1}
    assert make_mesh(2, 4, device="cpu").shards == (0, 1, 2, 3)
    with pytest.raises(ValueError):
        make_mesh(0, 2, device="cpu")


def test_mesh_engine_defaults_to_the_card():
    """make_mesh and global_mesh run on ``cuda`` unless the caller asks
    for the CPU; without a card the engine on the default mesh raises."""
    from numbskull_tpu_torch.parallel import multihost
    for fn in (make_mesh, multihost.global_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ShardedGibbsEngine(_dyadic_graph("ising"), make_mesh(1, 2))


@pytest.mark.parametrize("copies", [1, 3])
def test_replicate_matches_jax(copies):
    """replicate_graph and pool_chain_counts == the JAX package's."""
    from numbskull_tpu.models import lf_model as jax_lf_model
    port = replicate_graph(lf_model(0.5, [0.8, 0.6], copies=4, seed=2),
                           copies)
    ref = jax_replicate.replicate_graph(
        jax_lf_model(0.5, [0.8, 0.6], copies=4, seed=2), copies)
    for a, b in zip(port, ref):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype
        else:
            assert a == b
    counts = np.random.default_rng(0).integers(0, 9, (6 * copies, 3))
    assert np.array_equal(pool_chain_counts(counts, copies),
                          jax_replicate.pool_chain_counts(counts, copies))


def test_mesh_modules_import_no_jax():
    """In a fresh interpreter, after the mesh engine's inference,
    learning and marginals in process, replicate, the new top-level
    exports and an import of the two mesh drivers: no jax and no
    numbskull_tpu (the test process has imported both)."""
    code = (
        "import sys\n"
        "import numbskull_tpu_torch as nt\n"
        "from numbskull_tpu_torch.parallel import (ShardedGibbsEngine,\n"
        "                                          make_mesh, multihost)\n"
        "from numbskull_tpu_torch.models import (coin_model,\n"
        "                                        replicate_graph)\n"
        "w, v, f, fm, dm, _ = replicate_graph(coin_model(4), 2)\n"
        "cg = nt.compile_graph(w, v, f, fm, domain_mask=dm)\n"
        "e = ShardedGibbsEngine(cg, make_mesh(2, 2, device='cpu'))\n"
        "s = e.inference(e.init_state(), 1, 2, burn=1)\n"
        "e.marginals(s, 2)\n"
        "e.learn(e.init_state(), 1, 2, 0.1, lp=nt.LearnParams())\n"
        "nt.GibbsEngine, nt.save_checkpoint, nt.load_checkpoint\n"
        "nt.dbsource, nt.resilience, multihost.global_mesh\n"
        "import numbskull_tpu_torch.experiments.scaling\n"
        "import numbskull_tpu_torch.experiments.multiproc_scaling\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'numbskull_tpu' or "
        "m.startswith('numbskull_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
