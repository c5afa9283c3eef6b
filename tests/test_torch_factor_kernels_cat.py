"""Every factor function through the plain version of the fused sweep
kernel, against the TPU kernel in interpret mode, on the CPU: the
code's cat graph of ``chip_smoke.py`` phase 13 (a) (cardinality 3 to 8,
evidence clamped). ``test_torch_factor_kernels.py`` runs its a14 graph;
the two files split the work between two pytest-xdist workers.
"""

import pytest

from test_torch_factor_kernels import CODES, sweep_matches_tpu_kernel

from _torch_threads import cap_threads

cap_threads()


@pytest.mark.parametrize("name", CODES)
def test_plain_sweep_matches_tpu_kernel_cat(name):
    sweep_matches_tpu_kernel(name, "cat", False)
