"""The port's host layer against the JAX package's: compile output array
for array, the convert round trip, and the DeepDive binary fixture read
by both packages."""

import dataclasses

import numpy as np
import pytest
import torch

from numbskull_tpu import dataloading as jax_dl
from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu_torch import dataloading as port_dl
from numbskull_tpu_torch import models as port_models
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.convert import (compiled_graph_from_reference,
                                         sampler_state_from_reference)

from _torch_threads import cap_threads

cap_threads()


def coin_fixture(directory: str) -> str:
    """The reference's 18-variable coin fixture (the spec at
    tests/test_dataloading.py:11-25): one learnable weight at 0, 9
    evidence variables (8 true, 1 false) and 9 query variables, each
    with one ISTRUE factor."""
    w = T.new_weights(1)
    v = T.new_variables(18)
    v["isEvidence"][:9] = 1
    v["initialValue"][:8] = 1
    v["dataType"] = 0
    v["cardinality"] = 2
    f = T.new_factors(18)
    f["factorFunction"] = T.FUNC_ISTRUE
    f["weightId"] = 0
    f["featureValue"] = 1.0
    f["arity"] = 1
    f["ftv_offset"] = np.arange(18)
    fm = T.new_fmap(18)
    fm["vid"] = np.arange(18)
    port_dl.write_factor_graph_files(directory, w, v, f, fm)
    return directory


def _graphs():
    m = port_models
    yield "coin", m.coin_model(8, 0.5, -0.25, 0.5, evidence=False), {}
    yield "ising6x6", m.ising_grid(6, 6, weight=0.5), {}
    yield "lf_card3", m.lf_model(0.5, [0.5, 0.25], copies=5, seed=1), {}
    yield "voting_grouped", m.voting_grouped(400, 3, weight=0.5), {}
    yield "potts64", m.potts_grid(8, 16, card=64, weight=0.25), \
        {"color_hint": m.ising_color_hint(8, 16)}


GRAPHS = {name: (g, kw) for name, g, kw in _graphs()}


def _assert_fields_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if k == "plans":
            assert len(a[k]) == len(b[k])
            for pa, pb in zip(a[k], b[k]):
                _assert_fields_equal(pa, pb)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compile_matches_jax_package(name):
    (w, v, f, fm, dm, _), kw = GRAPHS[name]
    ours = compile_graph(w, v, f, fm, domain_mask=dm, **kw)
    ref = jax_compile_graph(w, v, f, fm, domain_mask=dm, **kw)
    _assert_fields_equal(dataclasses.asdict(ours), dataclasses.asdict(ref))


@pytest.mark.parametrize("name", ["lf_card3", "potts64"])
def test_convert_round_trip(name):
    (w, v, f, fm, dm, _), kw = GRAPHS[name]
    ref = jax_compile_graph(w, v, f, fm, domain_mask=dm, **kw)
    cg = compiled_graph_from_reference(dataclasses.asdict(ref))
    _assert_fields_equal(dataclasses.asdict(cg), dataclasses.asdict(ref))
    assert cg.n_colors == ref.n_colors and cg.kmax == ref.kmax
    # the converted graph owns its arrays
    cg.plans[0].it_row[0] += 1
    assert cg.plans[0].it_row[0] != ref.plans[0].it_row[0]

    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, cg.n_vars).astype(np.int32)
    cnt = rng.integers(0, 9, (cg.n_vars, cg.kmax)).astype(np.int32)
    st = sampler_state_from_reference(x, x[::-1], ref.weight_init, cnt,
                                      "cpu")
    assert st.device == torch.device("cpu")
    assert st.var_value.dtype == torch.int32
    assert st.weight_value.dtype == torch.float32
    np.testing.assert_array_equal(st.var_value.numpy(), x)
    np.testing.assert_array_equal(st.var_value_evid.numpy(), x[::-1])
    np.testing.assert_array_equal(st.count.numpy(), cnt)
    np.testing.assert_array_equal(st.weight_value.numpy(),
                                  np.asarray(ref.weight_init, np.float32))


def test_coin_fixture_loads_equal_in_both_packages(tmp_path):
    d = coin_fixture(str(tmp_path / "coin"))
    ours = port_dl.load_factor_graph_files(d)
    ref = jax_dl.load_factor_graph_files(d)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(a, dict):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    meta, w, v, f, fm, _, dmask = ours
    assert [int(meta[k]) for k in ("weights", "variables", "factors",
                                   "edges")] == [1, 18, 18, 18]
    assert (v["isEvidence"] == [1] * 9 + [0] * 9).all()
    assert (v["initialValue"][:9] == [1] * 8 + [0]).all()
    assert (f["factorFunction"] == T.FUNC_ISTRUE).all()
    assert (fm["vid"] == np.arange(18)).all()
    assert not dmask.any()
