"""Checkerboard Gibbs on an Ising lattice: the CUDA kernel and its plain
version.

Port of ``numbskull_tpu/ops/stencil_pallas.py`` (``_gibbs_kernel``,
``grid_gibbs_pallas``; ``PallasGridGibbsEngine.run`` is
``ops/stencil.GridGibbsEngine.run``). :func:`grid_gibbs`
runs ``burn`` untallied and ``epochs`` tallied sweeps of an n x m
lattice with EQUAL couplings of weight w and an ISTRUE bias b:

    half-step h (0, then 1) resamples the cells with (row + col) % 2 == h:
    s = sum of the up, down, left and right neighbours' values,
    deg = number of neighbours (4, 3 on an edge, 2 in a corner),
    dpot = fma(2w, 2s - deg, 2b)              (float32, one rounding),
    new = [u * (1 + exp(-dpot)) < 1]          (P(x = 1) = sigmoid(dpot)),

and after each tallied sweep adds every cell's value to its count. The
count returned holds this call's tallies only.

The TPU kernel draws with the TPU's hardware PRNG. The port draws with
the itemgrid kernels' counter hash (``ops/itemgrid.hash_uniforms``) on
the same 24-bit grid, ``(bits >> 8) * 2**-24``:

- hash seed ``int32(seed * 977)``;
- salt ``2 * sweep + half``, sweeps counted from 0 with the burn-in
  sweeps first;
- position ``(row, col)``;
- the initial lattice, when none is given: ``x0 = [u < 0.5]`` at salt
  -1 (:data:`INIT_SALT`).

CPU tensors take the plain version (:func:`grid_gibbs_reference`); CUDA
tensors launch ``csrc/stencil_gibbs.cu`` (all sweeps in one call) or
raise. There is no cell cap: the TPU kernel's ``MAX_CELLS`` was its VMEM
budget.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from numbskull_tpu_torch.ops.itemgrid import (_check, _ptr, _raise_if,
                                              _stream, fma32, hash_uniforms,
                                              seed977_of)

INIT_SALT = -1

#: launches of the CUDA stencil kernel in this process (two per sweep);
#: the wrapper adds them where it launches and nowhere else
STENCIL_LAUNCHES = 0


def two_w_b(weight: float, bias: float) -> tuple:
    """``(float32(2 w), float32(2 b))``, as Python floats."""
    return float(np.float32(2.0 * weight)), float(np.float32(2.0 * bias))


def lattice_index(n: int, m: int, device) -> tuple:
    """(rows, cols), each (n, m) int32."""
    r = torch.arange(n, dtype=torch.int32, device=device)
    c = torch.arange(m, dtype=torch.int32, device=device)
    return (r[:, None].expand(n, m).contiguous(),
            c[None, :].expand(n, m).contiguous())


def degrees(n: int, m: int, device) -> torch.Tensor:
    """Neighbour count of every cell, (n, m) float32."""
    rows, cols = lattice_index(n, m, device)
    return (4 - (rows == 0).int() - (rows == n - 1).int() -
            (cols == 0).int() - (cols == m - 1).int()).float()


def neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each cell's up, down, left and right neighbours, float32."""
    xf = x.float()
    s = torch.zeros_like(xf)
    s[1:, :] += xf[:-1, :]
    s[:-1, :] += xf[1:, :]
    s[:, 1:] += xf[:, :-1]
    s[:, :-1] += xf[:, 1:]
    return s


def grid_dpot(x: torch.Tensor, deg: torch.Tensor, two_w: float,
              two_b: float) -> torch.Tensor:
    """pot(1) - pot(0) of every cell: ``fma(2w, 2s - deg, 2b)``."""
    return fma32(two_w, 2.0 * neighbor_sum(x) - deg, two_b)


def half_step_reference(x: torch.Tensor, cells: torch.Tensor,
                        u: torch.Tensor, deg: torch.Tensor, two_w: float,
                        two_b: float) -> torch.Tensor:
    """``x`` with the ``cells`` (bool mask) redrawn from uniforms ``u``."""
    z = torch.exp(-grid_dpot(x, deg, two_w, two_b))
    new = (u * (1.0 + z) < 1.0).to(x.dtype)
    return torch.where(cells, new, x)


def initial_lattice(seed: int, n: int, m: int, device) -> torch.Tensor:
    """The lattice drawn from ``seed``: ``[u < 0.5]`` at INIT_SALT."""
    rows, cols = lattice_index(n, m, device)
    u = hash_uniforms(seed977_of(seed), INIT_SALT, rows, cols)
    return (u < 0.5).to(torch.int32)


def grid_gibbs_reference(x: torch.Tensor, seed: int, burn: int, epochs: int,
                         *, n: int, m: int, weight: float, bias: float,
                         uniforms=None):
    """Plain PyTorch version of :func:`grid_gibbs`, on any device.
    ``uniforms(sweep, half)``, when given, supplies each half-step's
    (n, m) float32 uniforms in place of the counter hash."""
    dev = x.device
    rows, cols = lattice_index(n, m, dev)
    parity = (rows + cols) % 2
    deg = degrees(n, m, dev)
    two_w, two_b = two_w_b(weight, bias)
    s977 = seed977_of(seed)
    x = x.clone()
    count = torch.zeros((n, m), dtype=torch.int32, device=dev)
    for s in range(burn + epochs):
        for half in (0, 1):
            u = uniforms(s, half) if uniforms is not None else \
                hash_uniforms(s977, 2 * s + half, rows, cols)
            x = half_step_reference(x, parity == half, u, deg, two_w, two_b)
        if s >= burn:
            count += x
    return x, count


_LIB = []


def _kernel_lib():
    """The built ``csrc/stencil_gibbs.cu``, its C signature declared."""
    if not _LIB:
        from numbskull_tpu_torch.ops._build import load_library
        lib = load_library("stencil_gibbs")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nsx_stencil_gibbs.restype = ctypes.c_int
        lib.nsx_stencil_gibbs.argtypes = [P, P, I, I, F, F, I, I, I, P]
        _LIB.append(lib)
    return _LIB[0]


def _launch(x: torch.Tensor, seed: int, burn: int, epochs: int, n: int,
            m: int, weight: float, bias: float):
    """All sweeps of one run through the CUDA kernel, on the current
    stream: one library call, two launches per sweep."""
    global STENCIL_LAUNCHES
    x = x.clone()
    count = torch.zeros((n, m), dtype=torch.int32, device=x.device)
    two_w, two_b = two_w_b(weight, bias)
    _raise_if(_kernel_lib().nsx_stencil_gibbs(
        _ptr(x), _ptr(count), n, m, two_w, two_b, seed977_of(seed), burn,
        epochs, _stream(x.device)), "stencil gibbs kernel")
    STENCIL_LAUNCHES += 2 * (burn + epochs)
    return x, count


def grid_gibbs(x: torch.Tensor, seed: int, burn: int, epochs: int, *,
               n: int, m: int, weight: float, bias: float):
    """``burn`` + ``epochs`` checkerboard sweeps of the (n, m) int32
    lattice ``x``; returns ``(x, count)``, new tensors on ``x``'s device.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (errors raise)."""
    if min(n, m) < 1 or burn < 0 or epochs < 0 or \
            burn + epochs >= 2 ** 31 // 2:
        raise ValueError("grid_gibbs: bad shape (%d, %d) or sweep count "
                         "(%d, %d)" % (n, m, burn, epochs))
    _check("x", x, torch.int32, x.device, (n, m))
    if x.device.type == "cpu":
        return grid_gibbs_reference(x, seed, burn, epochs, n=n, m=m,
                                    weight=weight, bias=bias)
    if x.device.type == "cuda":
        return _launch(x, seed, burn, epochs, n, m, weight, bias)
    raise ValueError("grid_gibbs: unsupported device %s" % x.device)

