"""Every factor function through the plain version of the fused learn
kernels, against the TPU learn kernel in interpret mode, on the CPU:
codes IMPLY_MLN to UFO (``test_torch_factor_learn.py`` has the others
and the details), and some also at cardinality 3 to 32 (``CAT32``).
The TPU learn kernel refuses cardinality above 32
(``itemgrid_pallas.py:2064``), so the KMAX 128 form is held to the
plain version on the card alone (``chip_smoke.py`` phases 2 and 13).
"""

import pytest

import chip_smoke
from numbskull_tpu.compile import compile_graph as jax_compile_graph
from numbskull_tpu.ops import itemgrid_pallas as jig
from numbskull_tpu_torch import types as T
from test_torch_factor_learn import CAT32, CODES, learn_matches_tpu_kernel

from _torch_threads import cap_threads

cap_threads()


@pytest.mark.parametrize("name", CODES[13:])
def test_plain_learn_matches_tpu_kernel_b(name):
    learn_matches_tpu_kernel(name)


@pytest.mark.parametrize("name", [n for n in CAT32 if n in CODES[13:]])
def test_plain_learn_matches_tpu_kernel_cat32_b(name):
    """CAT32's codes of IMPLY_MLN to UFO at cardinality 3 to 32."""
    learn_matches_tpu_kernel(name, "cat32")


def test_tpu_learn_kernel_refuses_cardinality_above_32():
    """Why the KMAX 128 learn form has no TPU kernel to be held to."""
    model = chip_smoke.random_graph(tuple(T.FACTORS), "cat128", 46,
                                    n_vars=30, n_factors=50)
    with pytest.raises(ValueError, match="caps cardinality at 32"):
        jig.PallasItemGridEngine(jax_compile_graph(*model),
                                 interpret=True).learn(
            seed=1, burn=0, epochs=1, stepsize=0.05)

