"""The gather microbenchmarks' kernels, their plain versions, and one
library call beside them.

Port of the Pallas TPU kernels of ``experiments/micro_gather.py``
(``make_kernel``, launched at ``:129``) and ``experiments/micro_gather2.py``
(``make_kernel``, launched at ``:105``). Each TPU mode is a way to build a
gather on a chip that has none (one-hot matmuls, lane rolls, factorized
one-hots), and every mode computes one of two functions of a float32
window ``x`` (its flat view) of 0/1 values:

- :func:`gather_sum`: ``out[r] = iters * sum_g x[off[g, r]]``, ``off``
  an ``(ng, R)`` int32 table of offsets into ``x``;
- :func:`shifted_sum`: ``out[r] = iters * sum_g sum_{j<span}
  x[shift[g] + R j + r]``, ``shift`` an ``(ng,)`` int32 vector.

:data:`TPU_MODES` maps each TPU mode to the function that computes it.
The TPU script's shapes have ``R = 1024``; both functions take any
``R >= 1``, so the gather is also measured at the sweep kernel's sizes.

CPU tensors run the plain versions (:func:`gather_sum_reference`,
:func:`shifted_sum_reference`); CUDA tensors launch
``csrc/gather_bench.cu`` or raise. :func:`library_gather_sum` is one
PyTorch call computing the same function (``embedding_bag``), a
yardstick that no main path calls. With 0/1 values every sum is an
integer, exact in float32 while ``iters * ng * span < 2**24``: the
kernels, the plain versions and the library call then agree bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from numbskull_tpu_torch.ops.itemgrid import _check, _ptr, _raise_if, _stream

#: TPU mode -> (the function that computes it, span)
TPU_MODES = {
    "f32_row": ("gather_sum", 1), "bf16_row": ("gather_sum", 1),
    "bf16_lane": ("gather_sum", 1), "bf16_lane_unr": ("gather_sum", 1),
    "bf16_batch": ("gather_sum", 1), "fact": ("gather_sum", 1),
    "take": ("gather_sum", 1), "roll": ("shifted_sum", 1),
    "roll_unr": ("shifted_sum", 1), "roll64": ("shifted_sum", 8),
}

#: windows up to this many bytes are staged in shared memory
#: (kSharedMaxBytes of csrc/gather_bench.cu)
SHARED_MAX_BYTES = 232448

#: launches of the CUDA gather_sum and shifted_sum kernels in this
#: process; each wrapper adds one where it launches and nowhere else
GATHER_LAUNCHES = 0
SHIFTED_LAUNCHES = 0


def _window(x: torch.Tensor) -> torch.Tensor:
    """The flat view of a contiguous float32 window."""
    _check("x", x, torch.float32, x.device)
    if x.numel() == 0:
        raise ValueError("x is empty")
    return x.reshape(-1)


def check_offsets(x: torch.Tensor, off: torch.Tensor) -> None:
    """Raise unless ``off`` is an (ng, R) int32 table on x's device, R >= 1,
    of offsets in [0, x.numel())."""
    _check("off", off, torch.int32, x.device)
    if off.dim() != 2 or off.shape[1] < 1:
        raise ValueError("off has shape %s, expected (ng, R >= 1)"
                         % (tuple(off.shape),))
    if off.numel() and (int(off.min()) < 0 or
                        int(off.max()) >= x.numel()):
        raise ValueError("off holds offsets outside [0, %d)" % x.numel())


def check_shifts(x: torch.Tensor, shift: torch.Tensor, R: int,
                 span: int) -> None:
    """Raise unless ``shift`` is an (ng,) int32 vector on x's device with
    0 <= shift[g] and shift[g] + R * span <= x.numel()."""
    _check("shift", shift, torch.int32, x.device)
    if shift.dim() != 1 or R < 1 or span < 1:
        raise ValueError("shift of shape %s with R %d, span %d: expected "
                         "(ng,), R >= 1, span >= 1"
                         % (tuple(shift.shape), R, span))
    if shift.numel() and (int(shift.min()) < 0 or
                          int(shift.max()) + R * span > x.numel()):
        raise ValueError("shift reads outside x: each shift + %d must "
                         "lie in [0, %d]" % (R * span, x.numel()))


def gather_sum_reference(x: torch.Tensor, off: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """Plain version of :func:`gather_sum`, on any device."""
    return iters * x.reshape(-1)[off.long()].sum(0)


def shifted_sum_reference(x: torch.Tensor, shift: torch.Tensor, R: int,
                          span: int, iters: int) -> torch.Tensor:
    """Plain version of :func:`shifted_sum`, on any device."""
    xf = x.reshape(-1)
    out = torch.zeros(R, dtype=torch.float32, device=x.device)
    for s in shift.tolist():
        out += xf[s:s + R * span].view(span, R).sum(0)
    return iters * out


def shifted_offsets(shift: torch.Tensor, R: int, span: int) -> torch.Tensor:
    """The (ng * span, R) int32 offsets ``shift[g] + R j + r`` that express
    :func:`shifted_sum` as :func:`gather_sum`."""
    r = torch.arange(R, dtype=torch.int32, device=shift.device)
    j = torch.arange(span, dtype=torch.int32, device=shift.device) * R
    return (shift[:, None, None] + j[None, :, None] +
            r[None, None, :]).reshape(-1, R)


def library_gather_sum(x: torch.Tensor, off_t: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """:func:`gather_sum` as one PyTorch call, ``embedding_bag`` (times
    ``iters``), from ``off_t = off.t().contiguous()``, which the caller
    makes outside any timed region. A yardstick only: no main path
    calls it."""
    return iters * torch.nn.functional.embedding_bag(
        off_t, x.reshape(-1, 1), mode="sum").reshape(-1)


_LIB = []


def _kernel_lib():
    """The built ``csrc/gather_bench.cu``, its C signatures declared."""
    if not _LIB:
        from numbskull_tpu_torch.ops._build import load_library
        lib = load_library("gather_bench")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.nsx_gather_sum.restype = ctypes.c_int
        lib.nsx_gather_sum.argtypes = [P, L, P, P, I, I, I, P]
        lib.nsx_shifted_sum.restype = ctypes.c_int
        lib.nsx_shifted_sum.argtypes = [P, L, P, P, I, I, I, I, P]
        _LIB.append(lib)
    return _LIB[0]


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    return x.device.type


def gather_sum(x: torch.Tensor, off: torch.Tensor, iters: int,
               validate: bool = True) -> torch.Tensor:
    """``out[r] = iters * sum_g x.flat[off[g, r]]``, an (R,) float32 tensor
    on x's device. CPU tensors run the plain version; CUDA tensors launch
    the kernel (errors raise). ``validate=False`` skips the range check
    of ``off`` (a reduction and a device-to-host copy), for timing loops
    over offsets checked once before."""
    global GATHER_LAUNCHES
    xf = _window(x)
    if iters < 0:
        raise ValueError("iters %d < 0" % iters)
    if validate:
        check_offsets(xf, off)
    else:
        _check("off", off, torch.int32, x.device)
    if _device_of(x, "gather_sum") == "cpu":
        return gather_sum_reference(xf, off, iters)
    ng, R = off.shape
    out = torch.empty(R, dtype=torch.float32, device=x.device)
    _raise_if(_kernel_lib().nsx_gather_sum(
        _ptr(xf), xf.numel(), _ptr(off), _ptr(out), R, ng, iters,
        _stream(x.device)), "gather_sum kernel")
    GATHER_LAUNCHES += 1
    return out


def shifted_sum(x: torch.Tensor, shift: torch.Tensor, R: int, span: int,
                iters: int, validate: bool = True) -> torch.Tensor:
    """``out[r] = iters * sum_g sum_{j<span} x.flat[shift[g] + R j + r]``,
    an (R,) float32 tensor on x's device. CPU tensors run the plain
    version; CUDA tensors launch the kernel (errors raise).
    ``validate=False`` skips the range check of ``shift``."""
    global SHIFTED_LAUNCHES
    xf = _window(x)
    if iters < 0:
        raise ValueError("iters %d < 0" % iters)
    if validate:
        check_shifts(xf, shift, R, span)
    else:
        _check("shift", shift, torch.int32, x.device)
    if _device_of(x, "shifted_sum") == "cpu":
        return shifted_sum_reference(xf, shift, R, span, iters)
    out = torch.empty(R, dtype=torch.float32, device=x.device)
    _raise_if(_kernel_lib().nsx_shifted_sum(
        _ptr(xf), xf.numel(), _ptr(shift), _ptr(out), R, shift.numel(),
        span, iters, _stream(x.device)), "shifted_sum kernel")
    SHIFTED_LAUNCHES += 1
    return out
