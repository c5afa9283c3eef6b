"""Every factor function through the plain version of the fused sweep
kernel, against the TPU kernel, on the CPU.

For each of the 25 factor codes, the single-code random graphs of
``chip_smoke.py`` phase 13 (a) (``chip_smoke.factor_fixtures_of``;
dyadic weights) that the TPU kernel runs here go through the port's
plain sweep (``ItemGridEngine.run`` on CPU tensors) under the schedule
of the JAX plan (``test_torch_itemgrid.schedule_from_jax_plan``) and
through ``PallasItemGridEngine(cg, interpret=True).run``: values and
counts, tolerance 0. ``test_torch_factor_learn.py`` does the same for
learning, ``test_torch_factor_golden.py`` holds the port's ``golden``
and the plain potentials to the JAX package's ``golden``.
"""

import dataclasses

import numpy as np
import pytest

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.ops import itemgrid as pig
from test_torch_itemgrid import schedule_from_jax_plan

import chip_smoke
from _torch_threads import cap_threads

cap_threads()

CODES = sorted(T.FACTORS)


def _graphs(name):
    """The single-code graphs of phase 13 (a) for code ``name``."""
    return [(n, m) for n, c, m in chip_smoke.factor_fixtures_of(name)]


def _jax_cg(model):
    return jax_compile_graph(*model)


def sweep_matches_tpu_kernel(name, kind, se):
    """Plain sweep == ``PallasItemGridEngine(interpret=True).run``,
    values and counts bit for bit, on code ``name``'s graph of ``kind``
    (sample_evidence ``se``), 1 burn-in and 2 tallied epochs. The TPU
    kernel's plan refuses the hub graphs (a row of more than 64 items);
    a13 takes one to two minutes an interpret-mode run; phase 13 runs
    both on the card."""
    sweep_model_matches_tpu_kernel(dict(_graphs(name))["%s/%s"
                                                       % (name, kind)], se)


def sweep_model_matches_tpu_kernel(model, se, seed=5):
    """``sweep_matches_tpu_kernel`` on graph ``model`` (w, v, f, fm)."""
    cg = _jax_cg(model)
    plan, reason = jig.plan_item_grid(cg, se)
    assert plan is not None, reason
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, sample_evidence=se, device="cpu",
                             schedule=schedule_from_jax_plan(cg, plan))
    x, c = eng.run(seed, 1, 2)
    x_ref, c_ref = jig.PallasItemGridEngine(
        cg, sample_evidence=se, interpret=True).run(seed=seed, burn=1,
                                                    epochs=2)
    np.testing.assert_array_equal(x.numpy(), x_ref)
    np.testing.assert_array_equal(c.numpy(), c_ref)


@pytest.mark.parametrize("name", CODES)
def test_plain_sweep_matches_tpu_kernel(name):
    """The code's boolean a14 graph, evidence resampled
    (``test_torch_factor_kernels_cat.py``: its cat graph)."""
    sweep_matches_tpu_kernel(name, "a14", True)


def test_tpu_plan_refuses_the_hub_graphs():
    """Why no hub graph is held to the TPU kernel here."""
    for name in CODES:
        cg = _jax_cg(dict(_graphs(name))[name + "/hub"])
        plan, reason = jig.plan_item_grid(cg, True)
        assert plan is None and "max row degree" in reason, name
