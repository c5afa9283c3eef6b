"""Every factor function through the plain version of the fused learn
kernels, against the TPU learn kernel, on the CPU.

For each of the 25 factor codes, one single-code random graph of
``chip_smoke.py`` phase 13 (a) (``chip_smoke.factor_fixtures_of``:
``cat``, cardinality 3 to 8, for the categorical, data-programming and
UFO codes, ``a14``, boolean, for the others; dyadic weights) learns
through the port's plain version (``ItemGridEngine.learn`` on CPU
tensors, under ``test_torch_learn.learn_schedule_from_jax_plan``) and
through ``PallasItemGridEngine(cg, interpret=True).learn``: weights,
free chain and clamped chain, tolerance 0. One learning epoch after one
burn-in sweep (about 4 s an epoch in interpret mode here), under L2, L1
with learn_non_evidence and ``grad_agg="sum"`` in turn. The codes are
split between this file and ``test_torch_factor_learn_b.py``, so that
two pytest-xdist workers share them.
"""

import dataclasses

import numpy as np
import pytest

from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu.ops.gibbs import LearnParams as JaxLearnParams
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.convert import compiled_graph_from_reference
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams
from test_torch_learn import learn_schedule_from_jax_plan

import chip_smoke
from _torch_threads import cap_threads

cap_threads()

CODES = sorted(T.FACTORS)
BOOLEAN = ("NOOP", "IMPLY_NATURAL", "OR", "AND", "EQUAL", "ISTRUE",
           "LINEAR", "RATIO", "LOGICAL", "IMPLY_MLN")


def learn_matches_tpu_kernel(name, kind=None):
    """Plain learn == interpret ``learn(return_state=True)`` bit for bit
    on the code's graph, and a weight moved; on NOOP's none did: the TPU
    kernel counts no NOOP item in a weight's step
    (itemgrid_pallas.py:363), so a weight of NOOP items alone keeps its
    value under every regularization (the port counted them and shrank
    it under ``grad_agg="sum"``)."""
    kind = kind or ("a14" if name in BOOLEAN else "cat")
    model = dict((n, m) for n, _, m in
                 chip_smoke.factor_fixtures_of(name))[name + "/" + kind]
    label, lpk = chip_smoke.FACTOR_LPS[CODES.index(name) % 3]
    want = learn_model_matches_tpu_kernel(model, lpk, 3 + CODES.index(name),
                                          label)
    moved = not np.array_equal(want[0], np.asarray(
        jax_compile_graph(*model).weight_init))
    assert moved == (name != "NOOP")


def learn_model_matches_tpu_kernel(model, lpk, seed, label=""):
    """Plain learn == interpret ``learn(return_state=True)`` bit for bit
    on graph ``model`` (w, v, f, fm) under LearnParams ``lpk``, 1
    burn-in and 1 epoch; returns the TPU kernel's (w, x, xe)."""
    cg = jax_compile_graph(*model)
    plan, reason = jig.plan_item_grid(cg, True)
    assert plan is not None, reason
    pcg = compiled_graph_from_reference(dataclasses.asdict(cg))
    eng = pig.ItemGridEngine(pcg, device="cpu",
                             schedule=learn_schedule_from_jax_plan(cg, plan))
    got = eng.learn(seed, 1, 1, 0.05, 1.0, LearnParams(**lpk))
    want = jig.PallasItemGridEngine(cg, interpret=True).learn(
        seed=seed, burn=1, epochs=1, stepsize=0.05, decay=1.0,
        lp=JaxLearnParams(**lpk), return_state=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=label)
    return want


@pytest.mark.parametrize("name", CODES[:13])
def test_plain_learn_matches_tpu_kernel(name):
    """Codes AND to EQUAL_CAT_CONST (``test_torch_factor_learn_b.py``:
    the others)."""
    learn_matches_tpu_kernel(name)


# codes held at cardinality 3 to 32 as well (``random_graph``'s cat32
# kind: the categorical learn kernel's KMAX 32 form on the card): one of
# each family of categorical semantics and the DP model's, those whose
# interpret-mode learn kernel builds in seconds (IMPLY_NATURAL_CAT takes
# over two minutes); phase 13 of chip_smoke.py runs every code there
CAT32 = ("AND_CAT", "DP_GEN_CLASS_PRIOR", "DP_GEN_DEP_FIXING",
         "DP_GEN_DEP_REINFORCING", "DP_GEN_LF_PRIOR", "DP_GEN_LF_PROPENSITY",
         "IMPLY_MLN_CAT", "UFO")


@pytest.mark.parametrize("name", [n for n in CAT32 if n in CODES[:13]])
def test_plain_learn_matches_tpu_kernel_cat32(name):
    """CAT32's codes of AND to EQUAL_CAT_CONST at cardinality 3 to 32
    (``test_torch_factor_learn_b.py``: the others)."""
    learn_matches_tpu_kernel(name, "cat32")

