"""Every factor function through the plain version of the fused learn
kernels, against the TPU learn kernel in interpret mode, on the CPU:
codes IMPLY_MLN to UFO (``test_torch_factor_learn.py`` has the others
and the details).
"""

import pytest

from test_torch_factor_learn import CODES, learn_matches_tpu_kernel

from _torch_threads import cap_threads

cap_threads()


@pytest.mark.parametrize("name", CODES[13:])
def test_plain_learn_matches_tpu_kernel_b(name):
    learn_matches_tpu_kernel(name)
