"""The gather kernels' plan (ops/gather.gather_plan) and their
decomposition, on the CPU, where the CUDA kernels cannot run.

The plan is checked at every shape the drivers, chip_smoke.py and the
tests use: its blocks and threads cover every output once, its shares
cover every (it, g) term once, it stays within a block's shared memory
and stages the window exactly where it fits. A numpy emulation of what
csrc/gather_bench.cu does with a plan (thread -> outputs -> shares ->
fixed tree, the columns the kernel reads beyond R included) equals the
plain versions bit for bit, tolerance 0: the values are 0/1, so every
partial sum is an exact integer. A stand-in for the built library records
what the wrappers pass to the C entry points.
"""

import numpy as np
import pytest
import torch

from numbskull_tpu_torch.experiments import micro_gather as mg
from numbskull_tpu_torch.experiments import micro_gather2 as mg2
from numbskull_tpu_torch.ops import gather as G

from _torch_threads import cap_threads

cap_threads()

RB = 1024


def _tpu_shapes():
    """(form, R, ng, span, iters, nx) of the TPU scripts' rows."""
    out = []
    for mod, pad, rows in (
            (mg, 8, [(m, trw, it, ng) for trw, it, ng in mg.VALIDATE
                     for m in mg.MODES] + list(mg.TIMING)),
            (mg2, 64, [(m, trw, it, ng)
                       for trw, it, ng in mg2.VALIDATE + mg2.TIMING
                       for m in mg2.MODES])):
        for mode, trw, iters, ng in rows:
            form, span = G.TPU_MODES[mode]
            out.append((form, RB, ng, span, iters, (trw + pad) * 128))
    return out


# chip_smoke.py's iters-scaling calls (tpu_data(16, 16, 64): 10240
# floats), k doubling from 1000 while 4 k ng span < 2^24
SCALING = [(form, RB, 16, span, k, 10240)
           for form, span in (("gather_sum", 1), ("shifted_sum", 8))
           for k in (1000, 2000, 4000, 8000, 16000, 32000, 64000)
           if 2 * k * 16 * span < 1 << 24]
SWEEP = [("gather_sum", mg.SWEEP_R, mg.SWEEP_NG, 1, 1, nx)
         for _, nx in mg.SWEEP_X] + \
    [("shifted_sum", mg2.SWEEP_R, mg2.SWEEP_NG, mg2.SPAN, 1, mg2.SWEEP_NX)]
# the drivers at chip_smoke's and the tests' smoke sizes, the tests' own
# calls, chip_smoke's ragged rows (staged and global), a shift chunk
# boundary
SMALL = [("gather_sum", 1 << 16, 59, 1, 1, nx)
         for nx in (1 << 20, 1 << 24)] + \
    [("shifted_sum", 1 << 16, 59, 8, 1, 1 << 24),
     ("gather_sum", RB, 16, 1, 200, 3072),
     ("shifted_sum", RB, 16, 1, 200, 3072),
     ("shifted_sum", RB, 16, 8, 200, 10240),
     ("gather_sum", 2048, 5, 1, 1, 4096), ("gather_sum", 2048, 5, 1, 1, 16384),
     ("shifted_sum", RB, 3, 8, 1, 16384),
     ("gather_sum", RB, 4, 1, 3, 3072), ("shifted_sum", RB, 4, 1, 3, 2048),
     ("shifted_sum", 8, 2, 8, 1, 100), ("gather_sum", 8, 2, 1, 1, 100)] + \
    [("gather_sum", R, 7, 1, 3, 3000) for R in (1, 1000, 5000)] + \
    [("gather_sum", 4097, 5, 1, 3, 50000),
     ("shifted_sum", 4097, 5, 8, 3, 50000)] + \
    [(form, R, 59, span, iters, nx)
     for form, span in (("gather_sum", 1), ("shifted_sum", 8))
     for R in (1, 3, 1023, 4097)
     for iters in (1, 3)
     for nx in (R * span + 4096, (1 << 20) + R * span)] + \
    [("shifted_sum", 3, G.SHIFT_CHUNK + 100, 1, 2, 50),
     ("gather_sum", 3, G.SHIFT_CHUNK + 100, 1, 2, 50)]
SHAPES = _tpu_shapes() + SCALING + SWEEP + SMALL


def _staged_bytes(form, R, ng, nx, plan):
    """The shared bytes of the staged layout: the staged indices, the
    shares' partial sums, the window."""
    idx = ng * plan.block_outputs if form == "gather_sum" else \
        min(ng, G.SHIFT_CHUNK)
    partials = plan.threads * plan.outputs if plan.shares > 1 else 0
    return 4 * (idx + partials + nx)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%s-R%d-ng%d-span%d"
                         "-it%d-nx%d" % s)
def test_plan_covers_outputs_and_terms(shape):
    """Each output in [0, R) is stored by exactly one thread (share 0 of
    its column); the shares of a column take each (it, g) once; the
    shared bytes fit a block; the window is staged exactly where the
    staged layout fits; the grid fills the card where R alone cannot."""
    form, R, ng, span, iters, nx = shape
    plan = G.gather_plan(*shape)
    assert plan.threads == G.THREADS and \
        plan.outputs == G.OUTPUTS[form, plan.staged]
    assert plan.shares & (plan.shares - 1) == 0 and \
        plan.threads % plan.shares == 0
    assert plan.blocks == -(-R // plan.block_outputs)
    stored = np.zeros(R, dtype=np.int64)
    for block in range(plan.blocks):
        for tid in range(plan.cols):           # share 0 of each column
            outs = np.asarray(plan.thread_outputs(block, tid))
            assert len(outs) == plan.outputs
            assert plan.thread_outputs(block, tid + plan.cols *
                                       (plan.shares - 1)) == list(outs)
            stored[outs[outs < R]] += 1
    assert (stored == 1).all()
    if iters * ng <= 1 << 21:
        seen = np.zeros(iters * ng, dtype=np.int64)
        for s in range(plan.shares):
            terms = plan.share_terms(s, ng, iters)
            if terms:
                it, g = np.asarray(terms).T
                np.add.at(seen, it * ng + g, 1)
        assert (seen == 1).all()
    assert plan.shared_bytes <= G.SHARED_MAX_BYTES
    staged = _staged_bytes(form, R, ng, nx, plan)
    assert plan.staged == (staged <= G.SHARED_MAX_BYTES)
    if plan.staged:
        assert plan.shared_bytes == staged
    assert plan.vector == (form == "gather_sum" and plan.staged)
    assert plan.batch == (8 if form == "gather_sum" or span == 1 else 1)
    cols = -(-R // plan.outputs)
    if iters * ng >= 4 * plan.threads * plan.batch and \
            cols * plan.threads <= G.CARD_THREADS:
        assert plan.shares == plan.threads          # as many as a block has
    elif plan.shares < plan.threads and \
            iters * ng >= 4 * plan.shares * plan.batch:
        assert 2 * plan.shares * cols > G.CARD_THREADS


def test_tpu_shapes_fill_the_card():
    """At the TPU scripts' timing shapes (R = 1024) the grid has 128
    blocks of 256 threads, 8 outputs a block, 128 shares an output; at
    the sweep sizes one thread per output (gather_sum, 4096 blocks) or
    per 4 outputs (the span-8 shifted_sum, 1024 blocks)."""
    for shape in _tpu_shapes():
        if shape[4] >= 200:
            plan = G.gather_plan(*shape)
            assert (plan.blocks, plan.shares, plan.block_outputs,
                    plan.staged) == (128, 128, 8, True)
    for shape in SWEEP:
        plan = G.gather_plan(*shape)
        assert (plan.blocks, plan.shares, plan.staged) == \
            (4096 if shape[0] == "gather_sum" else 1024, 1, False)


def _emulate(plan, xf, R, ng, span, iters, off=None, shift=None):
    """What the kernel computes with ``plan``: each share's sums of its
    terms over the columns its thread reads (beyond R: staged offset 0,
    or the column clamped into [0, R)), a shifted term's g found from its
    rank in its chunk's ascending shifts, the shares added in the
    kernel's tree (share s takes s + h, h = shares / 2 down to 1) in
    float32, and share 0's sums stored for outputs below R."""
    reads, targets = [], []
    for block in range(plan.blocks):
        for q in range(plan.cols):
            outs = plan.thread_outputs(block, q)
            for k, r in enumerate(outs):
                if plan.form == "gather_sum" and plan.staged:
                    col = r if r < R else -1          # offset 0
                else:
                    col = min(r, R - 1)
                reads.append(col)
                targets.append(r)
    reads, targets = np.asarray(reads), np.asarray(targets)
    # value[g, i]: term g at the i-th column read
    if plan.form == "gather_sum":
        offs = np.where(reads[None, :] >= 0,
                        off[:, np.maximum(reads, 0)], 0)
        value = xf[offs].astype(np.float64)
    else:
        value = np.zeros((ng, len(reads)))
        for g in range(ng):
            for j in range(span):
                value[g] += xf[shift[g] + R * j + reads]
    g_of = np.arange(ng)
    if plan.form == "shifted_sum":
        for g0 in range(0, ng, G.SHIFT_CHUNK):
            chunk = shift[g0:g0 + G.SHIFT_CHUNK]
            g_of[g0:g0 + len(chunk)] = g0 + np.argsort(chunk, kind="stable")
    count = np.zeros((plan.shares, ng))
    for s in range(plan.shares):
        for _, g in plan.share_terms(s, ng, iters):
            count[s, g_of[g]] += 1
    red = (count @ value).astype(np.float32)      # exact: integers
    h = plan.shares // 2
    while h:
        red[:h] += red[h:2 * h]
        h //= 2
    out = np.full(R, np.nan, dtype=np.float32)
    keep = targets < R
    out[targets[keep]] = red[0, keep]
    return out


@pytest.mark.parametrize("path", ["staged", "global"])
@pytest.mark.parametrize("form,span", [("gather_sum", 1),
                                       ("shifted_sum", 1),
                                       ("shifted_sum", 8)])
@pytest.mark.parametrize("R", [1, 3, 1023, 1024, 5000])
def test_emulated_decomposition_equals_plain(R, form, span, path):
    """The kernel's decomposition under its plan, emulated in numpy, ==
    the plain version bit for bit for ng in {1, 4, 59} and iters in
    {1, 2, 3}, with the window staged and not."""
    rng = np.random.default_rng(R * 7 + span)
    for ng in (1, 4, 59):
        for iters in (1, 2, 3):
            need = R * span if form == "shifted_sum" else 1
            nx = need + 37 if path == "staged" else need + 60000
            plan = G.gather_plan(form, R, ng, span, iters, nx)
            assert plan.staged == (path == "staged")
            xf = rng.integers(0, 2, nx).astype(np.float32)
            xt = torch.as_tensor(xf)
            if form == "gather_sum":
                off = rng.integers(0, nx, (ng, R)).astype(np.int32)
                got = _emulate(plan, xf, R, ng, span, iters, off=off)
                want = G.gather_sum_reference(xt, torch.as_tensor(off),
                                              iters)
            else:
                shift = rng.integers(0, nx - R * span + 1,
                                     ng).astype(np.int32)
                got = _emulate(plan, xf, R, ng, span, iters, shift=shift)
                want = G.shifted_sum_reference(
                    xt, torch.as_tensor(shift), R, span, iters)
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("path", ["staged", "global"])
@pytest.mark.parametrize("span", [1, 8])
def test_emulated_shift_chunks_equal_plain(span, path):
    """More shifts than one chunk (SHIFT_CHUNK, each sorted on its own),
    with repeated shifts (ties keep their order): the emulation == the
    plain version bit for bit."""
    rng = np.random.default_rng(span)
    R, ng, iters = 5, 2 * G.SHIFT_CHUNK + 37, 2
    nx = R * span + (40 if path == "staged" else 60000)
    plan = G.gather_plan("shifted_sum", R, ng, span, iters, nx)
    assert plan.staged == (path == "staged")
    xf = rng.integers(0, 2, nx).astype(np.float32)
    shift = rng.integers(0, 30, ng).astype(np.int32)
    got = _emulate(plan, xf, R, ng, span, iters, shift=shift)
    want = G.shifted_sum_reference(torch.as_tensor(xf),
                                   torch.as_tensor(shift), R, span, iters)
    np.testing.assert_array_equal(got, want.numpy())


class _FakeLib:
    """Stands in for the built library on the CPU: records each call's
    form, shapes and plan decisions."""
    def __init__(self):
        self.calls = []

    def nsx_gather_sum(self, x, nx, off, out, R, ng, iters, staged, shares,
                       stream):
        self.calls.append(("gather_sum", R, ng, iters, staged, shares))
        return 0

    def nsx_shifted_sum(self, x, nx, shift, out, R, ng, span, iters, staged,
                        shares, stream):
        self.calls.append(("shifted_sum", R, ng, iters, staged, shares))
        return 0


@pytest.mark.parametrize("shape", SHAPES[::7] + SWEEP,
                         ids=lambda s: "%s-R%d-ng%d-span%d-it%d-nx%d" % s)
def test_wrappers_pass_a_plan_the_entry_points_take(monkeypatch, shape):
    """The launch helpers hand the C entry points the plan's decisions
    (staged, shares) for the call's shapes (meta tensors: the shapes
    without the memory), and count one launch a call."""
    form, R, ng, span, iters, nx = shape
    fake = _FakeLib()
    monkeypatch.setattr(G, "_kernel_lib", lambda: fake)
    monkeypatch.setattr(G, "_stream", lambda dev: None)
    monkeypatch.setattr(G, "GATHER_LAUNCHES", 0)
    monkeypatch.setattr(G, "SHIFTED_LAUNCHES", 0)
    xf = torch.empty(nx, dtype=torch.float32, device="meta")
    if form == "gather_sum":
        G._launch_gather_sum(
            xf, torch.empty((ng, R), dtype=torch.int32, device="meta"),
            iters)
    else:
        G._launch_shifted_sum(
            xf, torch.empty(ng, dtype=torch.int32, device="meta"), R, span,
            iters)
    assert (G.GATHER_LAUNCHES, G.SHIFTED_LAUNCHES) == \
        ((1, 0) if form == "gather_sum" else (0, 1))
    plan = G.gather_plan(*shape)
    assert fake.calls == [(form, R, ng, iters, int(plan.staged),
                           plan.shares)]


def test_entry_point_refusal_raises(monkeypatch):
    """A launch the library refuses raises through _raise_if and is not
    counted; nothing falls back to the plain version."""
    class Refuses(_FakeLib):
        def nsx_gather_sum(self, *args):
            return 1

    monkeypatch.setattr(G, "_kernel_lib", lambda: Refuses())
    monkeypatch.setattr(G, "_stream", lambda dev: None)
    monkeypatch.setattr(G, "GATHER_LAUNCHES", 0)
    xf = torch.zeros(64)
    with pytest.raises(RuntimeError, match="gather_sum kernel launch failed"):
        G._launch_gather_sum(xf, torch.zeros((2, 8), dtype=torch.int32), 1)
    assert G.GATHER_LAUNCHES == 0


def test_plan_refuses_what_no_kernel_takes():
    """Unknown forms and empty shapes raise before any launch."""
    with pytest.raises(ValueError, match="unknown form"):
        G.gather_plan("take", 8, 1, 1, 1, 8)
    for bad in ((0, 1, 1, 1, 8), (8, -1, 1, 1, 8), (8, 1, 0, 1, 8),
                (8, 1, 1, -1, 8), (8, 1, 1, 1, 0)):
        with pytest.raises(ValueError, match="want"):
            G.gather_plan("shifted_sum", *bad)
