"""The gather microbenchmarks' plain versions (ops/gather) against the
TPU kernels of experiments/micro_gather.py and experiments/micro_gather2.py,
on the CPU.

Every TPU mode runs as its script builds it, ``make_kernel`` under
``pl.pallas_call``, here with ``interpret=True``, on the script's own
data (the same numpy draws); the port's plain version of the function
the mode computes (``ops/gather.TPU_MODES``) must give the same floats,
tolerance 0: the values are 0/1, so every sum is an exact integer.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from numbskull_tpu_torch.experiments.micro_gather import numpy_want, tpu_data
from numbskull_tpu_torch.ops import gather as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """The JAX experiment script ``experiments/<name>.py``, by path."""
    spec = importlib.util.spec_from_file_location(
        "tpu_" + name, os.path.join(REPO, "experiments", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SCRIPTS = {}


def _tpu_kernel(mode):
    """(script module, window padding) of the TPU script holding ``mode``."""
    name, pad = ("micro_gather2", 64) if mode in ("roll64", "fact",
                                                  "take") else \
        ("micro_gather", 8)
    if name not in _SCRIPTS:
        _SCRIPTS[name] = _script(name)
    return _SCRIPTS[name], pad


def _interpret(mod, mode, trw, iters, ng, x, off, shift):
    """The script's pallas_call (its ``run``), in interpret mode."""
    out = pl.pallas_call(
        mod.make_kernel(mode, trw, iters, ng),
        out_shape=jax.ShapeDtypeStruct((1, 1024), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(x, off, shift)
    return np.asarray(out)[0]


@pytest.mark.parametrize("ng", [4, 16])
@pytest.mark.parametrize("trw", [8, 16])
@pytest.mark.parametrize("mode", sorted(G.TPU_MODES))
def test_plain_equals_tpu_kernel_interpret(mode, trw, ng):
    """The plain version of the mode's function == the TPU kernel run in
    interpret mode, bit for bit, and == the script's numpy formula."""
    mod, pad = _tpu_kernel(mode)
    iters = 2
    x, off, shift = tpu_data(trw, ng, pad)
    want = _interpret(mod, mode, trw, iters, ng, x, off, shift)
    form, span = G.TPU_MODES[mode]
    xt = torch.as_tensor(x)
    if form == "gather_sum":
        got = G.gather_sum(xt, torch.as_tensor(off), iters)
    else:
        got = G.shifted_sum(xt, torch.as_tensor(shift[:ng]), 1024, span,
                            iters)
    assert got.dtype == torch.float32 and got.shape == (1024,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, numpy_want(mode, x, off, shift, trw, ng, iters))


def _random(nx, ng, R, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, nx).astype(np.float32)
    off = rng.integers(0, nx, (ng, R)).astype(np.int32)
    return x, off


@pytest.mark.parametrize("R", [1, 1000, 5000])
def test_library_equals_plain(R):
    """embedding_bag (the library yardstick) == the plain version, bit for
    bit, at R below, at and above one 1024-value block."""
    x, off = _random(3000, 7, R)
    xt, offt = torch.as_tensor(x), torch.as_tensor(off)
    plain = G.gather_sum_reference(xt, offt, 3)
    lib = G.library_gather_sum(xt, offt.t().contiguous(), 3)
    assert torch.equal(plain, lib)


def test_large_R_and_span8_against_numpy():
    """R = 4097 (beyond the TPU's 1024) and span 8 against the numpy
    formulas; the shifted sum also equals the random gather over its
    expanded offsets (shifted_offsets)."""
    R, ng, iters = 4097, 5, 3
    x, off = _random(50000, ng, R, seed=1)
    got = G.gather_sum(torch.as_tensor(x), torch.as_tensor(off), iters)
    np.testing.assert_array_equal(got.numpy(), iters * x[off].sum(0))
    span = 8
    shift = np.random.default_rng(2).integers(
        0, len(x) - R * span + 1, ng).astype(np.int32)
    want = np.zeros(R)
    for g in range(ng):
        want += x[shift[g]:shift[g] + R * span].reshape(span, R).sum(0)
    st = torch.as_tensor(shift)
    got = G.shifted_sum(torch.as_tensor(x), st, R, span, iters)
    np.testing.assert_array_equal(got.numpy(), iters * want)
    via = G.gather_sum(torch.as_tensor(x), G.shifted_offsets(st, R, span),
                       iters)
    assert torch.equal(got, via)


def test_out_of_range_raises():
    """Offsets outside [0, len(x)) and shifts whose span runs past x raise
    before any gather; a CPU call launches nothing."""
    x = torch.zeros(100)
    for bad in (-1, 100):
        off = torch.zeros((2, 8), dtype=torch.int32)
        off[1, 3] = bad
        with pytest.raises(ValueError, match="outside"):
            G.gather_sum(x, off, 1)
    with pytest.raises(ValueError, match="outside x"):
        G.shifted_sum(x, torch.tensor([0, 37], dtype=torch.int32), 8, 8, 1)
    with pytest.raises(ValueError, match="outside x"):
        G.shifted_sum(x, torch.tensor([-1], dtype=torch.int32), 8, 1, 1)
    with pytest.raises(ValueError, match="dtype"):
        G.gather_sum(x, torch.zeros((2, 8), dtype=torch.int64), 1)
    before = (G.GATHER_LAUNCHES, G.SHIFTED_LAUNCHES)
    G.gather_sum(x, torch.zeros((2, 8), dtype=torch.int32), 1)
    G.shifted_sum(x, torch.tensor([0, 36], dtype=torch.int32), 8, 8, 1)
    assert (G.GATHER_LAUNCHES, G.SHIFTED_LAUNCHES) == before
