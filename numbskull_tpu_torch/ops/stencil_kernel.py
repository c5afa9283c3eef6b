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
tensors launch ``csrc/stencil_gibbs.cu`` (all sweeps in one library
call) or raise. There is no cell cap: the TPU kernel's ``MAX_CELLS`` was
its VMEM budget.

The kernel runs k sweeps per launch on tiles held in shared memory, with
a halo of at least 2k cells that it updates redundantly (the `.cu`
header says why that is exact). :func:`lattice_plan` picks the tile and
k from the lattice's shape and the call's sweep count;
:meth:`LatticePlan.tiles` lists the tiles a launch's blocks write and
:attr:`LatticePlan.halos` the cells each window adds. The kernel keeps
the lattice in one byte a cell, so a CUDA call takes only the values 0
and 1 in ``x`` (:func:`check_binary`); the plain version and the TPU
kernel take any int32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from numbskull_tpu_torch.ops.itemgrid import (_check, _ptr, _raise_if,
                                              _stream, fma32, hash_uniforms,
                                              seed977_of)

INIT_SALT = -1

#: launches of the CUDA stencil kernel in this process (one per chunk of
#: k sweeps, ``LatticePlan.launches`` a call); the wrapper adds them where
#: it launches and nowhere else
STENCIL_LAUNCHES = 0

#: tallies are bytes in the kernel's shared memory
MAX_SWEEPS_PER_LAUNCH = 127
#: the kernel's block and shared-memory limits
MAX_THREADS = 1024
MAX_SHARED_BYTES = 232448

# (cells at least, tile rows, tile cols, sweeps per launch, window rows
# a thread, 8-cell words a thread), the first row the lattice reaches:
# the fastest plan at 8192^2, 2048^2 and 1024^2 on an H100 (PERF.md,
# from experiments/lattice_tiles.py)
_PLANS = ((1 << 24, 128, 256, 8, 8, 2),
          (1 << 21, 128, 256, 8, 8, 1),
          (0, 64, 128, 8, 2, 1))


class LatticePlan(NamedTuple):
    """How a call runs on the card: tiles of ``tile_rows`` x ``tile_cols``
    cells, ``k`` sweeps per launch, ``words_per_thread`` 8-cell words of
    ``rows_per_thread`` window rows a thread, ``launches`` launches."""
    tile_rows: int
    tile_cols: int
    k: int
    rows_per_thread: int
    words_per_thread: int
    launches: int

    @property
    def halos(self) -> tuple:
        """(above, below, left, right): the cells a block's window adds to
        its tile, as the kernel cuts it: 2k rows above, the rows below
        rounded up to whole thread strips, 2k columns rounded up to a
        thread's columns on each side."""
        k, rpt, cols = self.k, self.rows_per_thread, 8 * self.words_per_thread
        side = -(-2 * k // cols) * cols
        rows = -(-(self.tile_rows + 4 * k) // rpt) * rpt
        return 2 * k, rows - self.tile_rows - 2 * k, side, side

    @property
    def block(self) -> tuple:
        """(x, y) of the block the kernel launches: a thread per
        ``words_per_thread`` words of a window row and per strip of
        ``rows_per_thread`` rows."""
        above, below, left, right = self.halos
        return ((self.tile_cols + left + right) // (8 * self.words_per_thread),
                (self.tile_rows + above + below) // self.rows_per_thread)

    @property
    def shared_bytes(self) -> int:
        """The window with its ghost ring (a row above and below, a word
        left and right), the byte tallies and the draw's thresholds."""
        threads, strips = self.block
        words = threads * self.words_per_thread
        return 64 + (strips * self.rows_per_thread + 2) * (words + 2) * 8 + \
            self.tile_rows * self.tile_cols

    def tiles(self, n: int, m: int):
        """(row0, col0, row1, col1) of each block's tile, in block order:
        the cells it writes back."""
        for r0 in range(0, n, self.tile_rows):
            for c0 in range(0, m, self.tile_cols):
                yield (r0, c0, min(r0 + self.tile_rows, n),
                       min(c0 + self.tile_cols, m))


def make_plan(tile_rows: int, tile_cols: int, k: int, rows_per_thread: int,
              words_per_thread: int, sweeps: int) -> LatticePlan:
    """A plan for a call of ``sweeps`` sweeps; raises on a plan the kernel
    does not take."""
    plan = LatticePlan(tile_rows, tile_cols, k, rows_per_thread,
                       words_per_thread, -(-sweeps // k))
    cols = 8 * words_per_thread
    if not (1 <= k <= MAX_SWEEPS_PER_LAUNCH and tile_rows >= 1 and
            words_per_thread in (1, 2) and tile_cols >= cols and
            tile_cols % cols == 0 and rows_per_thread >= 1 and
            plan.block[0] * plan.block[1] <= MAX_THREADS and
            plan.shared_bytes <= MAX_SHARED_BYTES):
        raise ValueError("lattice plan: the kernel takes no tile %dx%d with "
                         "k %d and %d rows of %d words a thread"
                         % (tile_rows, tile_cols, k, rows_per_thread,
                            words_per_thread))
    return plan


def lattice_plan(n: int, m: int, sweeps: int) -> LatticePlan:
    """The plan of a call of ``sweeps`` sweeps on an n x m lattice: the
    row of the table the lattice's cells reach, its tile cut to the
    lattice (columns to whole words) and its k to the call's sweeps."""
    _, tr, tc, k, rpt, kw = next(p for p in _PLANS if n * m >= p[0])
    return make_plan(min(tr, n), min(tc, -(-m // (8 * kw)) * 8 * kw),
                     max(1, min(k, sweeps)), rpt, kw, sweeps)


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
        lib.nsx_stencil_gibbs.argtypes = [P, P, P, P, P, I, I, F, F, I, I,
                                          I, I, I, I, I, I, P]
        _LIB.append(lib)
    return _LIB[0]


def check_binary(x: torch.Tensor) -> None:
    """Raise ValueError unless every value of ``x`` is 0 or 1: the
    kernel's byte state holds nothing else. One reduction and one
    synchronisation."""
    if bool(torch.any(x & -2)):
        raise ValueError("grid_gibbs: the CUDA kernel takes lattice values "
                         "0 and 1 only")


def _launch(x: torch.Tensor, seed: int, burn: int, epochs: int, n: int,
            m: int, weight: float, bias: float, plan: LatticePlan):
    """All sweeps of one run through the CUDA kernel, on the current
    stream: one library call, ``plan.launches`` launches. ``x`` is read,
    never written."""
    global STENCIL_LAUNCHES
    if burn + epochs == 0:
        return x.clone(), torch.zeros_like(x)
    check_binary(x)
    x_out = torch.empty_like(x)
    count = torch.empty_like(x) if epochs else torch.zeros_like(x)
    bufs = [torch.empty((n, m), dtype=torch.uint8, device=x.device)
            if plan.launches > 1 + i else None for i in range(2)]
    two_w, two_b = two_w_b(weight, bias)
    _raise_if(_kernel_lib().nsx_stencil_gibbs(
        _ptr(x), _ptr(x_out), _ptr(count),
        *(ctypes.c_void_p(None) if b is None else _ptr(b) for b in bufs),
        n, m, two_w, two_b, seed977_of(seed), burn, epochs, plan.tile_rows,
        plan.tile_cols, plan.k, plan.rows_per_thread, plan.words_per_thread,
        _stream(x.device)),
        "stencil gibbs kernel")
    STENCIL_LAUNCHES += plan.launches
    return x_out, count


def grid_gibbs(x: torch.Tensor, seed: int, burn: int, epochs: int, *,
               n: int, m: int, weight: float, bias: float):
    """``burn`` + ``epochs`` checkerboard sweeps of the (n, m) int32
    lattice ``x``; returns ``(x, count)``, new tensors on ``x``'s device.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (errors raise; values of ``x`` other than 0 and 1 raise ValueError
    before any launch)."""
    if min(n, m) < 1 or burn < 0 or epochs < 0 or \
            burn + epochs >= 2 ** 31 // 2:
        raise ValueError("grid_gibbs: bad shape (%d, %d) or sweep count "
                         "(%d, %d)" % (n, m, burn, epochs))
    _check("x", x, torch.int32, x.device, (n, m))
    if x.device.type == "cpu":
        return grid_gibbs_reference(x, seed, burn, epochs, n=n, m=m,
                                    weight=weight, bias=bias)
    if x.device.type == "cuda":
        return _launch(x, seed, burn, epochs, n, m, weight, bias,
                       lattice_plan(n, m, burn + epochs))
    raise ValueError("grid_gibbs: unsupported device %s" % x.device)

