"""The port's lattice engine (ops/stencil, ops/stencil_kernel) against the
JAX package's, on the CPU.

The TPU kernel draws with the TPU's hardware PRNG, which the Pallas
interpreter returns as zeros; the port draws with a counter hash. So the
kernel is held to the port's plain version bit for bit only under
injected zero uniforms, one half-step is held to the JAX formula under
given uniforms, and whole runs are held to exact marginals and to the
JAX XLA engine statistically (the tolerances are stated at each test).

Where exp(-dpot) overflows float32 (dpot below about -88.7) or XLA's
sigmoid is 0 (dpot at or below about -87.3), the two draw forms differ
at u = 0: between those points XLA gives P(x=1) = 0 and the port draws
1. Every fixture's dpot values avoid the band [-104, -87]
(:func:`_avoids_band`).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from numbskull_tpu import golden
from numbskull_tpu.models import ising_grid
from numbskull_tpu.ops.stencil import GridGibbsEngine as JaxGridEngine
from numbskull_tpu.ops.stencil_pallas import PallasGridGibbsEngine
from numbskull_tpu_torch.convert import grid_state_from_reference
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops import stencil_kernel as sk
from numbskull_tpu_torch.ops.stencil import GridGibbsEngine

from _torch_threads import cap_threads

cap_threads()


def _dpot_values(w, b):
    """Every dpot a cell can take: fma(2w, k, 2b) for k = 2s - deg."""
    tw, tb = sk.two_w_b(w, b)
    k = torch.arange(-4, 5, dtype=torch.float32)
    return sk.fma32(tw, k, tb).numpy()


def _avoids_band(w, b):
    d = _dpot_values(w, b)
    return not ((d >= -104.0) & (d <= -87.0)).any()


def _x0(n, m, seed=0):
    return np.random.default_rng(seed).integers(0, 2, (n, m)).astype(
        np.int32)


# ---- the kernel's mechanics against the TPU kernel (interpret mode) ----

@pytest.mark.parametrize("n,m,w,b", [(8, 8, 0.4, 0.0), (8, 8, -30.0, 0.0),
                                     (5, 7, 0.4, 0.3)])
def test_zero_uniforms_match_tpu_kernel_interpret(n, m, w, b):
    """grid_gibbs_reference with zero uniforms == PallasGridGibbsEngine
    (interpret=True, whose PRNG yields zeros): x and count, tolerance 0."""
    assert _avoids_band(w, b)
    x0 = _x0(n, m, seed=n * m)
    burn, epochs = 2, 5
    x_ref, c_ref = PallasGridGibbsEngine(n, m, w, b, interpret=True).run(
        seed=0, burn=burn, epochs=epochs, x0=jnp.asarray(x0))
    zeros = torch.zeros((n, m), dtype=torch.float32)
    x, c = sk.grid_gibbs_reference(torch.as_tensor(x0), 0, burn, epochs,
                                   n=n, m=m, weight=w, bias=b,
                                   uniforms=lambda s, h: zeros)
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    if w == -30.0:                     # the antiferromagnet freezes
        assert set(np.unique(c.numpy())) == {0, epochs}


@pytest.mark.parametrize("n,m,w,b", [
    (16, 16, 0.4, 0.3), (5, 7, 1.234567, 0.333333), (1, 9, 0.37, -0.71),
    (9, 1, 0.8, 0.2), (8, 8, -30.0, 0.0), (6, 10, 3.0, -2.5)])
@pytest.mark.parametrize("half", [0, 1])
def test_half_step_matches_jax_formula(n, m, w, b, half):
    """One half-step under given uniforms against the JAX engine's
    _neighbor_sum, _deg and stencil.py:76-81 (jitted, as the engine runs
    it): neighbour sums and degrees exact, dpot exact (both one fma), and
    the draw equal wherever |u - sigmoid(dpot)| > 2^-22."""
    assert _avoids_band(w, b)
    rng = np.random.default_rng(n * 100 + m)
    x = rng.integers(0, 2, (n, m)).astype(np.int32)
    u = (rng.integers(0, 1 << 24, (n, m)) / float(1 << 24)).astype(
        np.float32)
    je = JaxGridEngine(n, m, w, b)

    @jax.jit
    def jax_half(x, u):
        s = je._neighbor_sum(x)
        dpot = 2.0 * je.weight * (2.0 * s - je._deg) + 2.0 * je.bias_weight
        p1 = jax.nn.sigmoid(dpot)
        new = jnp.where(je._parity == half, (u < p1).astype(jnp.int32), x)
        return s, dpot, p1, new

    s_j, dpot_j, p1_j, new_j = (np.asarray(a) for a in
                                jax_half(jnp.asarray(x), jnp.asarray(u)))
    xt = torch.as_tensor(x)
    deg = sk.degrees(n, m, "cpu")
    tw, tb = sk.two_w_b(w, b)
    np.testing.assert_array_equal(sk.neighbor_sum(xt).numpy(), s_j)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(je._deg))
    np.testing.assert_array_equal(sk.grid_dpot(xt, deg, tw, tb).numpy(),
                                  dpot_j)
    rows, cols = sk.lattice_index(n, m, "cpu")
    new = sk.half_step_reference(xt, (rows + cols) % 2 == half,
                                 torch.as_tensor(u), deg, tw, tb).numpy()
    clear = np.abs(u.astype(np.float64) - p1_j) > 2.0 ** -22
    np.testing.assert_array_equal(new[clear], new_j[clear])
    assert clear.mean() > 0.9


# ---- statistics ---------------------------------------------------------

def _exact_3x3(w, b):
    """Exact P(x=1) of every cell of a 3x3 lattice, by enumeration."""
    n = m = 3
    best = np.zeros(n * m)
    z = 0.0
    for bits in itertools.product((0, 1), repeat=n * m):
        x = np.asarray(bits).reshape(n, m)
        eq = (x[1:, :] == x[:-1, :]).sum() + (x[:, 1:] == x[:, :-1]).sum()
        pairs = (n - 1) * m + n * (m - 1)
        e = np.exp(w * (2 * eq - pairs) + b * (2 * x.sum() - n * m))
        best += e * x.ravel()
        z += e
    return best / z


@pytest.mark.parametrize("w,b", [(0.4, 0.0), (0.4, 0.3)])
def test_marginals_match_exact(w, b):
    """3x3 marginals within 0.04 of exact enumeration at 8000 epochs (the
    tolerance of tests/test_stencil.py); without bias the enumeration is
    golden.exact_marginals'."""
    exact = _exact_3x3(w, b)
    if b == 0.0:
        wt, v, f, fm, dm, e = ising_grid(3, 3, weight=w)
        np.testing.assert_allclose(
            golden.exact_marginals(v, f, fm, wt["initialValue"])[:, 1],
            exact, atol=1e-9)
    eng = GridGibbsEngine(3, 3, w, b, device="cpu")
    st = eng.inference(eng.init_state(), seed=1, epochs=8000, burn=300)
    marg = eng.marginals(st, 8000)
    assert np.abs(marg.ravel() - exact).max() < 0.04


def test_matches_jax_xla_engine():
    """4x4 at w=0.3, b=0.2: the port's marginals within 0.05 of the JAX
    GridGibbsEngine's (6000 epochs each, two independent streams). The
    coupling stays below the critical one (about 0.44), where a 4x4
    chain at w=0.5 dwells in one magnetised state long enough to move a
    6000-epoch marginal by 0.05 on its own; the bias keeps the marginals
    off the symmetric 0.5."""
    n = 4
    je = JaxGridEngine(n, n, 0.3, 0.2)
    js = je.inference(je.init_state(), jax.random.PRNGKey(4), epochs=6000,
                      burn=300)
    want = je.marginals(js, 6000)
    assert want.mean() > 0.6
    eng = GridGibbsEngine(n, n, 0.3, 0.2, device="cpu")
    st = eng.inference(eng.init_state(3), seed=3, epochs=6000, burn=300)
    assert np.abs(eng.marginals(st, 6000) - want).max() < 0.05


def test_bias_weight():
    """w = 0, b = 0.7: mean marginal within 0.03 of sigmoid(2b)."""
    eng = GridGibbsEngine(4, 4, 0.0, bias_weight=0.7, device="cpu")
    st = eng.inference(eng.init_state(), seed=0, epochs=8000, burn=100)
    want = 1.0 / (1.0 + np.exp(-1.4))
    assert eng.marginals(st, 8000).mean() == pytest.approx(want, abs=0.03)


# ---- the engines and the wrapper ----------------------------------------

def test_same_seed_same_bits():
    """Same seed and state: the same bits; another seed: other bits. The
    count holds one call's tallies; x0 is drawn from the seed."""
    eng = GridGibbsEngine(12, 9, 0.3, 0.1, device="cpu")
    x1, c1 = eng.run(seed=5, burn=3, epochs=40)
    x2, c2 = eng.run(seed=5, burn=3, epochs=40)
    assert torch.equal(x1, x2) and torch.equal(c1, c2)
    x3, c3 = eng.run(seed=6, burn=3, epochs=40)
    assert not torch.equal(c1, c3)
    assert torch.equal(sk.initial_lattice(5, 12, 9, "cpu"),
                       sk.initial_lattice(5, 12, 9, "cpu"))
    _, c4 = eng.run(seed=5, burn=0, epochs=7, x0=x1)
    assert int(c4.max()) <= 7 and int(c4.min()) >= 0


def test_engine_continues_a_jax_state():
    """A JAX GridState carried over (convert.grid_state_from_reference):
    inference starts from its x and adds its tallies to its count."""
    je = JaxGridEngine(6, 5, 0.3)
    js = je.inference(je.init_state(), jax.random.PRNGKey(0), epochs=20)
    st = grid_state_from_reference(js.x, js.count, "cpu")
    eng = GridGibbsEngine(6, 5, 0.3, device="cpu")
    out = eng.inference(st, seed=2, epochs=10, burn=1)
    x, c = sk.grid_gibbs(st.x, 2, 1, 10, n=6, m=5, weight=0.3, bias=0.0)
    assert torch.equal(out.x, x)
    assert torch.equal(out.count, st.count + c)
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(js.count))


def test_no_cell_cap():
    """A lattice beyond the TPU kernel's MAX_CELLS (1024 x 1024) runs."""
    assert 1100 * 1000 > PallasGridGibbsEngine.MAX_CELLS
    x, c = GridGibbsEngine(1100, 1000, 0.3, device="cpu").run(1, 0, 1)
    assert x.shape == (1100, 1000) and int(c.sum()) == int(x.sum())


def test_wrapper_checks_and_never_launches_on_cpu():
    x = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        sk.grid_gibbs(x, 0, 0, 1, n=4, m=5, weight=0.1, bias=0.0)
    with pytest.raises(ValueError, match="dtype"):
        sk.grid_gibbs(x.long(), 0, 0, 1, n=4, m=4, weight=0.1, bias=0.0)
    with pytest.raises(ValueError, match="sweep count"):
        sk.grid_gibbs(x, 0, -1, 1, n=4, m=4, weight=0.1, bias=0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.grid_gibbs(x.to("meta"), 0, 0, 1, n=4, m=4, weight=0.1,
                      bias=0.0)
    sk.grid_gibbs(x, 0, 1, 2, n=4, m=4, weight=0.1, bias=0.0)
    assert sk.STENCIL_LAUNCHES == 0 and pig.KERNEL_LAUNCHES == 0


# ---- the CUDA kernel's tiled schedule, emulated on the CPU ---------------

def _tiled_emulation(x, seed, burn, epochs, n, m, w, b, plan, halos=None):
    """What csrc/stencil_gibbs.cu computes, in plain PyTorch, block by
    block: per chunk of plan.k sweeps, each tile's window (the tile and
    the plan's halos, with a ghost ring of one row above and below and
    one 8-cell word left and right, all clipped at the lattice's edges)
    is cut from the chunk's input lattice and runs the chunk's 2k
    half-steps on its own with half_step_reference's arithmetic (global
    degrees and hash positions; the ghost ring is read, never updated);
    only the tile is kept, and its tallies of the chunk's sweeps >= burn
    are added. ``halos`` replaces the plan's."""
    rows, cols = sk.lattice_index(n, m, "cpu")
    deg = sk.degrees(n, m, "cpu")
    tw, tb = sk.two_w_b(w, b)
    s977 = sk.seed977_of(seed)
    above, below, left, right = plan.halos if halos is None else halos
    x = x.clone()
    count = torch.zeros((n, m), dtype=torch.int32)
    sweeps = burn + epochs
    for s0 in range(0, sweeps, plan.k):
        s1 = min(s0 + plan.k, sweeps)
        new = x.clone()
        for r0, c0, r1, c1 in plan.tiles(n, m):
            lo_r, hi_r = r0 - above, r0 + plan.tile_rows + below
            lo_c, hi_c = c0 - left, c0 + plan.tile_cols + right
            gr = slice(max(lo_r - 1, 0), min(hi_r + 1, n))
            gc = slice(max(lo_c - 8, 0), min(hi_c + 8, m))
            win = x[gr, gc].clone()
            wr, wc = rows[gr, gc], cols[gr, gc]
            inside = (wr >= lo_r) & (wr < hi_r) & (wc >= lo_c) & (wc < hi_c)
            tile = (wr >= r0) & (wr < r1) & (wc >= c0) & (wc < c1)
            tally = torch.zeros_like(win)
            for s in range(s0, s1):
                for half in (0, 1):
                    u = sk.hash_uniforms(s977, 2 * s + half, wr, wc)
                    win = sk.half_step_reference(
                        win, inside & ((wr + wc) % 2 == half), u,
                        deg[gr, gc], tw, tb)
                if s >= burn:
                    tally += win
            new[r0:r1, c0:c1] = win[tile].view(r1 - r0, c1 - c0)
            count[r0:r1, c0:c1] += tally[tile].view(r1 - r0, c1 - c0)
        x = new
    return x, count


# (n, m, tile rows, tile cols, k, rows a thread, words a thread, burn,
# epochs, w, b): odd and even sides; sides of T - 1, T, T + 1 and 2T + 1
# for 4 x 8 and 4 x 16 tiles; burn k - 1, k, k + 1; one epoch; k beyond
# the call's sweeps; 1 x m and n x 1; a bias; the antiferromagnet;
# strips of 1 to 4 rows; one and two words a thread
TILED = [
    (9, 17, 4, 8, 2, 2, 1, 1, 3, 0.4, 0.0),
    (10, 16, 4, 8, 2, 4, 1, 2, 3, 0.4, 0.0),
    (3, 7, 4, 8, 2, 2, 1, 3, 2, 0.4, 0.0),
    (4, 8, 4, 8, 2, 1, 1, 1, 4, 0.4, 0.0),
    (5, 9, 4, 8, 3, 2, 1, 2, 2, 0.4, 0.0),
    (9, 17, 4, 8, 3, 3, 1, 3, 2, 0.4, 0.0),
    (9, 17, 4, 8, 3, 2, 1, 4, 3, 0.4, 0.0),
    (8, 8, 4, 8, 2, 2, 1, 0, 1, 0.4, 0.0),
    (8, 8, 4, 8, 8, 2, 1, 2, 3, 0.4, 0.0),
    (1, 37, 4, 8, 2, 2, 1, 1, 4, 0.4, 0.2),
    (41, 1, 4, 8, 2, 4, 1, 1, 4, 0.4, -0.2),
    (12, 11, 4, 8, 2, 2, 1, 2, 3, 0.3, 0.7),
    (13, 13, 4, 8, 2, 2, 1, 1, 3, -30.0, 0.0),
    (1, 1, 4, 8, 2, 2, 1, 3, 2, 0.4, 0.3),
    (9, 33, 4, 16, 2, 2, 2, 1, 3, 0.4, 0.1),
    (5, 15, 4, 16, 3, 2, 2, 2, 2, 0.4, 0.0),
    (13, 17, 4, 16, 3, 4, 2, 3, 3, 0.3, 0.7),
]


@pytest.mark.parametrize("n,m,tr,tc,k,rpt,kw,burn,epochs,w,b", TILED)
def test_tiled_schedule_matches_reference(n, m, tr, tc, k, rpt, kw, burn,
                                          epochs, w, b):
    """The kernel's decomposition (tiles with their halos, k sweeps a
    chunk, tallies per chunk) == grid_gibbs_reference, x and count,
    tolerance 0."""
    x0 = torch.as_tensor(_x0(n, m, seed=n + 7 * m))
    plan = sk.make_plan(tr, tc, k, rpt, kw, burn + epochs)
    x, c = _tiled_emulation(x0, 3, burn, epochs, n, m, w, b, plan)
    x_r, c_r = sk.grid_gibbs_reference(x0, 3, burn, epochs, n=n, m=m,
                                       weight=w, bias=b)
    assert torch.equal(x, x_r) and torch.equal(c, c_r)


def test_tiled_schedule_needs_a_halo():
    """Without the halo (the ghost ring alone) the tiles go wrong: the
    redundant updates are what makes the schedule exact."""
    n, m = 16, 16
    x0 = torch.as_tensor(_x0(n, m, seed=5))
    plan = sk.make_plan(4, 8, 3, 2, 1, 6)
    x_r, c_r = sk.grid_gibbs_reference(x0, 3, 0, 6, n=n, m=m, weight=0.4,
                                       bias=0.0)
    x, c = _tiled_emulation(x0, 3, 0, 6, n, m, 0.4, 0.0, plan,
                            halos=(0, 0, 0, 0))
    assert not (torch.equal(x, x_r) and torch.equal(c, c_r))


@pytest.mark.parametrize("n,m,sweeps", [
    (1, 1, 1), (1, 70000, 3), (70000, 3, 3), (1024, 1024, 250),
    (2048, 2048, 40), (8192, 8192, 25), (129, 63, 7), (5000, 4099, 9)])
def test_plan_tiles_cover_every_cell_once(n, m, sweeps):
    """The plan's tiles cover every cell exactly once; k divides the
    sweeps into ``launches`` chunks; the window fits the kernel."""
    plan = sk.lattice_plan(n, m, sweeps)
    hits = np.zeros((n, m), dtype=np.int32)
    for r0, c0, r1, c1 in plan.tiles(n, m):
        assert r0 < r1 and c0 < c1
        hits[r0:r1, c0:c1] += 1
    assert (hits == 1).all()
    assert plan.launches == -(-sweeps // plan.k) and plan.k <= sweeps
    above, below, left, right = plan.halos
    cols = 8 * plan.words_per_thread
    assert above == 2 * plan.k and below >= 2 * plan.k and \
        left == right >= 2 * plan.k and left % cols == 0
    threads, strips = plan.block
    assert plan.tile_cols % cols == 0 and threads * strips <= sk.MAX_THREADS
    assert plan.shared_bytes <= sk.MAX_SHARED_BYTES


class _FakeLib:
    """Stands in for the built library on the CPU: records each call and
    counts the launches its chunk loop would make."""
    def __init__(self):
        self.calls = []

    def nsx_stencil_gibbs(self, *args):
        burn, epochs, k = args[10], args[11], args[14]
        assert args[15] >= 1 and args[16] in (1, 2)   # rows, words a thread
        self.calls.append(-(-(burn + epochs) // k))
        return 0


@pytest.mark.parametrize("n,m,burn,epochs", [
    (1024, 1024, 50, 200), (8192, 8192, 0, 25), (33, 17, 3, 4),
    (3, 70000, 1, 2), (16, 16, 2, 0)])
def test_wrapper_adds_the_plans_launches(monkeypatch, n, m, burn, epochs):
    """_launch adds plan.launches to STENCIL_LAUNCHES, the number of
    chunks the library's loop launches for the plan's k."""
    fake = _FakeLib()
    monkeypatch.setattr(sk, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(sk, "_stream", lambda dev: None)
    monkeypatch.setattr(sk, "STENCIL_LAUNCHES", 0)
    plan = sk.lattice_plan(n, m, burn + epochs)
    x = torch.zeros((n, m), dtype=torch.int32)
    sk._launch(x, 1, burn, epochs, n, m, 0.3, 0.0, plan)
    assert fake.calls == [plan.launches]
    assert sk.STENCIL_LAUNCHES == plan.launches


def test_wrapper_refuses_values_beyond_0_and_1(monkeypatch):
    """A CUDA-bound call whose x holds a value other than 0 or 1 raises
    ValueError before anything launches (the check, on the CPU)."""
    fake = _FakeLib()
    monkeypatch.setattr(sk, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(sk, "_stream", lambda dev: None)
    monkeypatch.setattr(sk, "STENCIL_LAUNCHES", 0)
    for bad in (2, -1, 1 << 30):
        x = torch.zeros((6, 6), dtype=torch.int32)
        x[3, 4] = bad
        with pytest.raises(ValueError, match="0 and 1"):
            sk._launch(x, 1, 1, 2, 6, 6, 0.3, 0.0, sk.lattice_plan(6, 6, 3))
    assert fake.calls == [] and sk.STENCIL_LAUNCHES == 0
    sk.check_binary(torch.tensor([[0, 1], [1, 0]], dtype=torch.int32))


@pytest.mark.parametrize("w,b", [(0.3, 0.0), (0.4, 0.3), (-30.0, 0.0),
                                 (1.234567, -0.7)])
def test_draw_threshold_is_exact(w, b):
    """The kernel draws q < T[level] in place of u * (1 + exp(-dpot)) < 1
    (u = q * 2^-24, q the hash's 24 bits): for every q and every level
    the two agree, with T found by the kernel's bisection (exp here is
    torch's, the kernel's is expf: the claim is the monotone prefix)."""
    tw, tb = sk.two_w_b(w, b)
    u = torch.arange(1 << 24, dtype=torch.int32).float() * (1.0 / (1 << 24))
    for level in range(-4, 5):
        dpot = sk.fma32(tw, float(level), tb)
        opz = (1.0 + torch.exp(-dpot)).float()
        lo, hi = 0, 1 << 24
        while lo < hi:
            mid = (lo + hi) // 2
            if float(u[mid] * opz) < 1.0:
                lo = mid + 1
            else:
                hi = mid
        draws = u * opz < 1.0
        assert int(draws.sum()) == lo and bool(draws[:lo].all())
