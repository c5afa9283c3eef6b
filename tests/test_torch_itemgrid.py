"""The port's fused sweep against the TPU kernel, on the CPU.

The JAX package's itemgrid kernel runs here in interpret mode with its
software PRNG; the port's ItemGridEngine runs its plain PyTorch version
(CPU tensors) under a schedule derived from the JAX plan — same color
order, draw positions, position maps and draw formulas. With dyadic
weights every potential sum is exact in any order (ops/parity.py), so
values and counts must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.models import (coin_model, ising_color_hint, ising_grid,
                                  lf_model, potts_grid, voting_grouped)
from numbskull_tpu.ops import gibbs as jax_gibbs
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops import parity
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.models import coin_exact_marginal
from numbskull_tpu_torch.models import coin_model as port_coin_model
from numbskull_tpu_torch.compile import compile_graph as port_compile_graph
from numbskull_tpu_torch.ops import gibbs as port_gibbs
from numbskull_tpu_torch.ops import itemgrid as pig

from _torch_threads import cap_threads

cap_threads()


def schedule_from_jax_plan(cg, plan) -> pig.Schedule:
    """The JAX kernel's sweep as a port Schedule: kernel colors mapped to
    compile colors as ops/parity.py does, upos = perm[vid] - row0 * 128,
    `tile`/`sigmoid2` on affine colors, else `row` with `vec` when
    kmax >= 9 and `cdf` below."""
    perm = np.asarray(plan.perm, np.int64)
    order_by_pos = np.argsort(perm)
    all_pos = perm[order_by_pos]
    upos = np.zeros(cg.n_vars, np.int64)
    colors, maps, draws = [], [], []
    for ci in range(plan.cmeta.shape[0]):
        num_rb, row0 = int(plan.cmeta[ci, 1]), int(plan.cmeta[ci, 2])
        lo, hi = row0 * 128, (row0 + num_rb * 8) * 128
        sel = order_by_pos[np.searchsorted(all_pos, lo):
                           np.searchsorted(all_pos, hi)]
        cc = np.unique(cg.color_of[sel])
        assert len(cc) == 1
        colors.append(int(cc[0]))
        upos[sel] = perm[sel] - row0 * 128
        if plan.cmeta[ci, 5] == 1:
            maps.append("tile")
            draws.append("sigmoid2")
        else:
            maps.append("row")
            draws.append("vec" if plan.kmax >= jig.VEC_K_MIN else "cdf")
    return pig.Schedule(colors=tuple(colors), maps=tuple(maps),
                        draws=tuple(draws), upos=upos)


def _port_run(cg, seed, burn, epochs, sample_evidence):
    plan, reason = jig.plan_item_grid(cg, sample_evidence)
    assert plan is not None, reason
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, sample_evidence=sample_evidence,
                             device="cpu",
                             schedule=schedule_from_jax_plan(cg, plan))
    x, c = eng.run(seed, burn, epochs)
    return x.numpy(), c.numpy(), plan


# ---- the four non-slow fixtures of tests/test_parity.py ---------------

def _coin():
    w, v, f, fm, dm, _ = coin_model(8, 0.5, -0.25, 0.5, evidence=False,
                                    weight_init=(0.5, -0.25, 0.5),
                                    fixed=True)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _ising_no_sample_evidence():
    w, v, f, fm, dm, _ = ising_grid(5, 5, weight=0.25)
    v["isEvidence"][:5] = 1
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _lf():
    w, v, f, fm, dm, _ = lf_model(0.5, [0.5], copies=3, seed=1)
    w["initialValue"] = [0.5, 0.25]
    w["isFixed"] = True
    v["isEvidence"] = 0
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _voting():
    w, v, f, fm, dm, _ = voting_grouped(10000, 3, weight=0.5)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm)


def _potts64():
    w, v, f, fm, dm, _ = potts_grid(8, 16, card=64, weight=0.25)
    return jax_compile_graph(w, v, f, fm, domain_mask=dm,
                             color_hint=ising_color_hint(8, 16))


FIXTURES = {
    # name: (builder, seed, burn, epochs, sample_evidence)
    "coin_affine": (_coin, 3, 4, 30, True),
    "ising_no_sample_evidence": (_ising_no_sample_evidence, 2, 3, 40,
                                 False),
    "categorical_lf": (_lf, 5, 5, 40, True),
    "voting_sb4": (_voting, 7, 2, 8, True),
}


@pytest.mark.parametrize("name", sorted(FIXTURES) + ["potts64"])
def test_color_potentials_bit_equal(name):
    """The port's plain potentials equal ops/gibbs.color_potentials bit
    for bit on every color of every fixture (the precondition of the
    exact draw comparisons below)."""
    cg = _potts64() if name == "potts64" else FIXTURES[name][0]()
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 1 << 30, cg.n_vars) %
         np.asarray(cg.var_card)).astype(np.int32)
    w = np.asarray(cg.weight_init, np.float32)
    for c, p in enumerate(pcg.plans):
        want = np.asarray(jax_gibbs.color_potentials(
            jax_gibbs._plan_device_arrays(cg.plans[c], cg.n_vars), p.kmax,
            pig.present_types_of(p.it_ftype), jnp.asarray(x),
            jnp.asarray(w)))
        got = port_gibbs.color_potentials(
            port_gibbs.plan_tensors(p, "cpu"), p.kmax,
            pig.present_types_of(p.it_ftype), torch.as_tensor(x),
            torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_slice_matches_tpu_kernel_interpret(name):
    """ItemGridEngine (plain path) == PallasItemGridEngine(interpret=True)
    .run: values and counts, tolerance 0."""
    build, seed, burn, epochs, se = FIXTURES[name]
    cg = build()
    x, c, plan = _port_run(cg, seed, burn, epochs, se)
    x_ref, c_ref = jig.PallasItemGridEngine(
        cg, sample_evidence=se, interpret=True).run(seed=seed, burn=burn,
                                                     epochs=epochs)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(c, c_ref)
    if name in ("coin_affine", "voting_sb4"):
        assert (plan.cmeta[:, 5] == 1).any()      # tile/sigmoid2 covered
    if name == "categorical_lf":
        assert (plan.cmeta[:, 5] == 0).any()      # row/cdf covered


def test_slice_matches_kernel_parity_run_potts64():
    """Card-64 Potts 8x16 (the `vec` draw) against the kernel's schedule
    replay (interpret mode is too slow at this cardinality)."""
    cg = _potts64()
    x, c, plan = _port_run(cg, 3, 2, 12, True)
    assert plan.kmax == 64 and not (plan.cmeta[:, 5] == 1).any()
    x_ref, c_ref = parity.kernel_parity_run(cg, seed=3, burn=2, epochs=12)
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(c, c_ref)


# ---- the counter hash and the three draws ------------------------------

@pytest.mark.parametrize("tile", [False, True])
@pytest.mark.parametrize("seed,epoch,ci", [
    (0, 0, 0), (3, 1, 2), (2 ** 31 - 1, 7, 1),       # seed * 977 wraps
    (123456789, 9_000_000, 255),                      # salt base wraps
    (2 ** 30 + 5, 65535, 3)])                         # salt * 65536 wraps
def test_block_uniforms_bit_equal(tile, seed, epoch, ci):
    s977 = pig.seed977_of(seed)
    assert s977 == int(np.int64(seed) * 977 % 2 ** 32) - \
        (2 ** 32 if np.int64(seed) * 977 % 2 ** 32 >= 2 ** 31 else 0)
    salt_base = pig._i32(epoch * (pig.COLOR_MAX + 1) + ci)
    n_blocks = 3
    want = parity._block_uniforms(s977, salt_base, 0, n_blocks, aff=tile)
    got = pig.block_uniforms(s977, pig.salt16_of(epoch, ci),
                             torch.arange(n_blocks * 1024), tile)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _dyadic_case(kmax, n=4096, seed=0):
    rng = np.random.default_rng(seed + kmax)
    pot = (rng.integers(-64, 65, (n, kmax)) / 16.0).astype(np.float32)
    card = rng.integers(1, kmax + 1, n).astype(np.int32)
    card[: n // 2] = kmax                           # full rows too
    u = (rng.integers(0, 1 << 24, n) / float(1 << 24)).astype(np.float32)
    return pot, card, u


@pytest.mark.parametrize("kmax", [2, 3, 8, 9, 64, 128])
def test_draws_bit_equal(kmax):
    pot, card, u = _dyadic_case(kmax)
    tp, tc, tu = (torch.as_tensor(a) for a in (pot, card, u))
    want_cdf = np.asarray(jig._draw(
        [jnp.asarray(pot[:, k][None]) for k in range(kmax)],
        jnp.asarray(card[None]), kmax, jnp.asarray(u[None])))[0]
    np.testing.assert_array_equal(pig.draw_cdf(tp, tc, kmax, tu).numpy(),
                                  want_cdf)
    want_vec = np.asarray(jig._draw_vec(
        jnp.asarray(pot.T.copy()), jnp.asarray(card[None]), kmax,
        jnp.asarray(u[None])))[0]
    np.testing.assert_array_equal(pig.draw_vec(tp, tc, kmax, tu).numpy(),
                                  want_vec)
    want2 = np.asarray(jig._draw2(jnp.asarray(pot[:, 0][None]),
                                  jnp.asarray(pot[:, -1][None]),
                                  jnp.asarray(u[None])))[0]
    np.testing.assert_array_equal(
        pig.draw_sigmoid2(tp[:, 0], tp[:, -1], tu).numpy(), want2)


# ---- the port's own schedule ------------------------------------------

def test_default_schedule_coin_marginals():
    """Coin model marginals within 0.02 of the exact joint at 4000
    epochs (the library check of the verify notes)."""
    a, b, c = 0.3, -0.2, 0.4
    w, v, f, fm, dm, _ = port_coin_model(16, evidence=False,
                                         weight_init=(a, b, c), fixed=True)
    cg = port_compile_graph(w, v, f, fm, domain_mask=dm)
    eng = pig.ItemGridEngine(cg, device="cpu")
    assert set(eng.schedule.draws) == {"sigmoid2"}
    assert set(eng.schedule.maps) == {"row"}
    _, counts = eng.run(seed=11, burn=100, epochs=4000)
    marg = counts.numpy().astype(np.float64) / 4000
    exact = coin_exact_marginal(a, b, c)
    assert abs(marg[0::2, 1].mean() - (exact[2] + exact[3])) < 0.02
    assert abs(marg[1::2, 1].mean() - (exact[1] + exact[3])) < 0.02


def test_default_schedule_draws():
    """Boolean colors draw with sigmoid2; other colors with cdf when
    kmax <= 8 and vec above; ranks are the draw positions."""
    cg = compiled_graph_from_reference(dataclasses.asdict(_lf()))
    s = pig.default_schedule(cg)
    cards = np.asarray(cg.var_card)
    for c, draw in zip(s.colors, s.draws):
        p = cg.plans[c]
        vids = p.cv_vid[p.cv_valid]
        assert draw == ("sigmoid2" if (cards[vids] == 2).all() else "cdf")
        np.testing.assert_array_equal(s.upos[vids], np.arange(len(vids)))
    cg64 = compiled_graph_from_reference(dataclasses.asdict(_potts64()))
    assert set(pig.default_schedule(cg64).draws) == {"vec"}


def test_wrapper_rejects_other_devices_and_large_schedules():
    cg = compiled_graph_from_reference(dataclasses.asdict(_coin()))
    eng = pig.ItemGridEngine(cg, device="cpu")
    x = torch.zeros(cg.n_vars, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pig.sweep_color(eng.tables, 0, x, x, x, 0, 0, True)
    with pytest.raises(ValueError):
        pig.Schedule(colors=tuple(range(pig.COLOR_MAX + 1)),
                     maps=("row",) * (pig.COLOR_MAX + 1),
                     draws=("cdf",) * (pig.COLOR_MAX + 1),
                     upos=np.zeros(1))
    assert pig.KERNEL_LAUNCHES == 0     # CPU runs never launch


def test_launch_counts_only_launches():
    """A step with no rows launches nothing and counts nothing; tables
    not built on the card hold no kernel pointers, so a launch from
    them raises instead of running."""
    cg = compiled_graph_from_reference(dataclasses.asdict(_coin()))
    t = pig.ItemGridEngine(cg, device="cpu").tables
    assert t.ptrs == ()
    x = torch.as_tensor(cg.var_init, dtype=torch.int32)
    counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32)
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32)
    before = pig.KERNEL_LAUNCHES
    empty = dataclasses.replace(t, n_rows=[0] * t.n_steps)
    x0 = x.clone()
    pig._launch_sweep(empty, 0, x, counts, w, 0, 0, True)
    assert torch.equal(x, x0) and int(counts.sum()) == 0
    with pytest.raises(ValueError, match="not built for the kernel"):
        pig._launch_sweep(t, 0, x, counts, w, 0, 0, True)
    with pytest.raises(ValueError, match="shape"):
        pig._launch_sweep(t, 0, x[:-1], counts, w, 0, 0, True)
    assert pig.KERNEL_LAUNCHES == before
