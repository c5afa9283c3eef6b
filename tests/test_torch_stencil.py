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
