"""Every factor function through the plain version of the fused sweep
kernel, against the TPU kernel in interpret mode, on the CPU: the
code's cat graph of ``chip_smoke.py`` phase 13 (a) (cardinality 3 to 8,
evidence clamped), and every code in one graph at cardinality 3 to 32
and 3 to 128 (``random_graph``'s cat32 and cat128 kinds: the `vec`
draw, and the categorical kernels' KMAX 32 and 128 forms on the card).
``test_torch_factor_kernels.py`` runs the a14 graphs; the two files
split the work between two pytest-xdist workers.
"""

import pytest

import chip_smoke
from numbskull_tpu_torch import types as T
from test_torch_factor_kernels import (CODES, sweep_matches_tpu_kernel,
                                       sweep_model_matches_tpu_kernel)

from _torch_threads import cap_threads

cap_threads()


@pytest.mark.parametrize("name", CODES)
def test_plain_sweep_matches_tpu_kernel_cat(name):
    sweep_matches_tpu_kernel(name, "cat", False)


@pytest.mark.parametrize("kind,seed", [("cat32", 41), ("cat32", 42),
                                       ("cat128", 43), ("cat128", 44)])
def test_plain_sweep_matches_tpu_kernel_every_code(kind, seed):
    """Every code in one graph of 40 variables and 80 factors, evidence
    resampled, 1 burn-in and 2 tallied epochs."""
    codes = tuple(T.FACTORS)
    sweep_model_matches_tpu_kernel(chip_smoke.random_graph(
        codes, kind, seed, n_vars=40, n_factors=80), True, seed)

