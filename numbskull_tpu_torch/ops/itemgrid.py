"""Fused chromatic Gibbs inference: the sweep kernel, its plain version,
and the engine that drives them.

Port of ``numbskull_tpu/ops/itemgrid_pallas.py`` (``_make_kernel`` and
``PallasItemGridEngine.run``) and of the schedule replay in
``numbskull_tpu/ops/parity.py:37-67``. The TPU kernel's packed layout,
windowed one-hot gathers, color-major renumbering and int16 tallies
existed to work around the TPU's missing gather and its VMEM cap; none
of them is carried over. Values stay in original variable order on the
device, every color's rows and their items live in flat CSR tables
(:func:`build_tables`), and one launch of ``csrc/itemgrid_sweep.cu``
per (epoch, color) resamples a color with one thread per row.

What is kept exactly are the inputs to every draw, so that a run can be
held bit for bit against the TPU kernel's software-PRNG path:

- the counter hash ``_uniform_sw`` with seed ``int32(seed * 977)`` and
  salt ``int32(int32(epoch * (COLOR_MAX + 1) + ci) * 65536 + block)``;
- two position maps: ``row`` (block = upos // 1024, i0 = 0,
  i1 = upos % 1024) and ``tile`` (i0 = (upos % 1024) // 128,
  i1 = upos % 128);
- three draws: ``cdf`` (``_draw``), ``vec`` (``_draw_vec``, a
  Hillis-Steele prefix sum over the global kmax width) and
  ``sigmoid2`` (``_draw2``).

A :class:`Schedule` says, per step of a sweep, which compile color runs
and with which map and draw, and gives every variable its draw position
``upos``. :func:`default_schedule` is the port's own; the tests derive
one from the JAX package's ``ItemGridPlan`` to compare the two engines.

:func:`sweep_color` is the wrapper: CPU tensors take the plain version
(:func:`color_step_reference`), CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import present_types_of
from numbskull_tpu_torch.ops.gibbs import color_potentials, plan_tensors
from numbskull_tpu_torch.types import EV_EVIDENCE, EV_QUERY

COLOR_MAX = 256      # salt stride is COLOR_MAX + 1: at most 256 colors
VEC_K_MIN = 9        # kmax >= this draws with `vec`, below with `cdf`
K_MAX_SUP = 128      # largest cardinality the kernel is built for
RB = 1024            # positions per uniform block

MAPS = ("row", "tile")
DRAWS = ("cdf", "vec", "sigmoid2")

ROW_UPDATE = 1       # row_flags bits (csrc/itemgrid_sweep.cu)
ROW_TALLY = 2

#: launches of the CUDA sweep kernel in this process; the wrapper adds
#: one where it launches and nowhere else
KERNEL_LAUNCHES = 0


def _i32(v: int) -> int:
    """The int32 with the low 32 bits of ``v``."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


_H0, _H1, _H2, _H3 = (_i32(c) for c in (0x9E3779B9, 0x85EBCA6B,
                                        0xC2B2AE35, 0x27D4EB2F))
_H4, _H5 = _i32(0x2C1B3C6D), _i32(0x297A2D39)


def seed977_of(seed: int) -> int:
    """The hash seed of a run: ``int32(seed * 977)``."""
    return _i32(int(seed) * 977)


def salt16_of(epoch: int, ci: int) -> int:
    """``int32(int32(epoch * (COLOR_MAX + 1) + ci) * 65536)``: the salt
    of block 0 of sweep step ``ci`` in ``epoch`` (burn-in counted)."""
    return _i32((int(epoch) * (COLOR_MAX + 1) + int(ci)) * 65536)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 ``x``."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def block_uniforms(seed977: int, salt16: int, upos: torch.Tensor,
                   tile: bool) -> torch.Tensor:
    """The TPU kernel's software uniform at draw positions ``upos``.

    int32 arithmetic throughout: multiplication wraps to the low 32
    bits that uint32 would keep, and every right shift is masked to be
    logical."""
    upos = upos.to(torch.int32)
    blk = upos >> 10
    pos = upos & (RB - 1)
    if tile:
        i0, i1 = pos >> 7, pos & 127
    else:
        i0, i1 = torch.zeros_like(pos), pos
    salt = blk + salt16
    x = (i0 * _H0) ^ (i1 * _H1) ^ _i32(seed977 * _H2) ^ (salt * _H3)
    x = (x ^ _lsr(x, 15)) * _H4
    x = (x ^ _lsr(x, 12)) * _H5
    x = x ^ _lsr(x, 15)
    return _lsr(x, 8).to(torch.float32) * (1.0 / (1 << 24))


def draw_cdf(pot: torch.Tensor, card: torch.Tensor, kmax: int,
             u01: torch.Tensor) -> torch.Tensor:
    """``_draw``: masked max, sequential sum of exp, sequential
    cumulative count. pot (N, >= kmax), card/u01 (N,)."""
    m = pot[:, 0]
    for k in range(1, kmax):
        m = torch.where((k < card) & (pot[:, k] > m), pot[:, k], m)
    zero = torch.zeros((), dtype=pot.dtype, device=pot.device)
    zs = [torch.where(k < card, torch.exp(pot[:, k] - m), zero)
          for k in range(kmax)]
    total = zs[0]
    for k in range(1, kmax):
        total = total + zs[k]
    u = u01 * total
    csum = torch.zeros_like(total)
    val = torch.zeros_like(card)
    for k in range(kmax):
        csum = csum + zs[k]
        val = val + (csum < u).to(val.dtype)
    return torch.minimum(val, card - 1)


def draw_vec(pot: torch.Tensor, card: torch.Tensor, kmax: int,
             u01: torch.Tensor) -> torch.Tensor:
    """``_draw_vec``: masked max, then a Hillis-Steele inclusive prefix
    sum over the global ``kmax`` width (its add tree depends on kmax,
    not on the row's card)."""
    pot = pot[:, :kmax]
    kio = torch.arange(kmax, device=pot.device)[None, :]
    valid = kio < card[:, None]
    m = torch.where(valid, pot, float("-inf")).amax(dim=1, keepdim=True)
    zero = torch.zeros((), dtype=pot.dtype, device=pot.device)
    csum = torch.where(valid, torch.exp(pot - m), zero)
    s = 1
    while s < kmax:
        csum = csum + torch.nn.functional.pad(csum[:, :-s], (s, 0))
        s *= 2
    u = u01[:, None] * csum[:, kmax - 1:kmax]
    val = (csum < u).sum(dim=1).to(card.dtype)
    return torch.minimum(val, card - 1)


def draw_sigmoid2(p0: torch.Tensor, p1: torch.Tensor,
                  u01: torch.Tensor) -> torch.Tensor:
    """``_draw2``: new = [u * (1 + exp(p0 - p1)) < 1]."""
    z = torch.exp(p0 - p1)
    return (u01 * (1.0 + z) < 1.0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The order and draw inputs of one sweep.

    Step ``ci`` resamples compile color ``colors[ci]`` with position map
    ``maps[ci]`` and draw ``draws[ci]``; ``upos`` (V,) is every
    variable's draw position within its color."""

    colors: tuple
    maps: tuple
    draws: tuple
    upos: np.ndarray

    def __post_init__(self):
        n = len(self.colors)
        if len(self.maps) != n or len(self.draws) != n:
            raise ValueError("schedule: colors, maps and draws differ in "
                             "length")
        if n > COLOR_MAX:
            raise ValueError("schedule: %d colors > %d (the salt stride)"
                             % (n, COLOR_MAX))
        if any(m not in MAPS for m in self.maps) or \
                any(d not in DRAWS for d in self.draws):
            raise ValueError("schedule: unknown map or draw")


def default_schedule(cg: CompiledGraph) -> Schedule:
    """The port's own schedule: colors in ``cg.plans`` order, the `row`
    map, ``upos`` = rank within the color; all-boolean colors draw with
    `sigmoid2`, others with `cdf` when kmax <= 8 and `vec` above."""
    upos = np.zeros(cg.n_vars, np.int64)
    draws = []
    for p in cg.plans:
        vids = p.cv_vid[p.cv_valid].astype(np.int64)
        upos[vids] = np.arange(len(vids))
        if len(vids) and (np.asarray(cg.var_card)[vids] == 2).all():
            draws.append("sigmoid2")
        else:
            draws.append("vec" if cg.kmax >= VEC_K_MIN else "cdf")
    C = cg.n_colors
    return Schedule(colors=tuple(range(C)), maps=("row",) * C,
                    draws=tuple(draws), upos=upos)


@dataclasses.dataclass
class SweepTables:
    """A graph's sweep, flattened for the kernel and uploaded once.

    Rows (variables) of every step are concatenated in schedule order,
    with their items in CSR form and the items' arguments in flat
    arrays. ``plans`` keeps each step's ColorPlan, from which the plain
    version computes its potentials (:meth:`plan_tensors`, built on
    first use, so a kernel-only run never uploads them)."""

    kmax: int
    n_vars: int
    n_weights: int
    row_vid: torch.Tensor      # (N,) int32
    row_card: torch.Tensor     # (N,) int32
    row_upos: torch.Tensor     # (N,) int32
    row_flags: torch.Tensor    # (N,) int8: ROW_UPDATE | ROW_TALLY
    row_item: torch.Tensor     # (N + 1,) int32 CSR offsets into items
    it_ftype: torch.Tensor     # (I,) int32
    it_wid: torch.Tensor       # (I,) int32
    it_arity: torch.Tensor     # (I,) int32
    it_arg: torch.Tensor       # (I,) int32 offset of the first argument
    it_dense: torch.Tensor     # (I,) int8
    it_d1: torch.Tensor        # (I,) int32
    it_d2: torch.Tensor        # (I,) int32
    arg_vid: torch.Tensor      # (E,) int32
    arg_eq: torch.Tensor       # (E,) int32
    arg_card: torch.Tensor     # (E,) int32
    arg_subst: torch.Tensor    # (E,) int8
    row0: list                 # per step: first row
    n_rows: list               # per step: row count
    map_codes: list            # per step: index into MAPS
    draw_codes: list           # per step: index into DRAWS
    plans: list                # per step: the ColorPlan of its color
    present: list              # per step: factor codes present
    ptrs: tuple = ()           # the kernel's table pointers (CUDA only)
    _plan_tensors: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.row_vid.device

    @property
    def n_steps(self) -> int:
        return len(self.row0)

    def plan_tensors(self, ci: int) -> dict:
        """Step ``ci``'s plan tensors on the tables' device."""
        if ci not in self._plan_tensors:
            self._plan_tensors[ci] = plan_tensors(self.plans[ci],
                                                  self.device)
        return self._plan_tensors[ci]


def build_tables(cg: CompiledGraph, schedule: Schedule,
                 sample_evidence: bool, device) -> SweepTables:
    """Flatten ``cg.plans`` in schedule order into CSR tables on
    ``device``. A row may update when it is a query variable, or an
    evidence variable under ``sample_evidence``; it is tallied iff it
    may update (itemgrid_pallas.py:426-427)."""
    var_card = np.asarray(cg.var_card, np.int64)
    isev = np.asarray(cg.var_isev, np.int64)
    upd_v = (isev == EV_QUERY) | (bool(sample_evidence) &
                                  (isev == EV_EVIDENCE))
    rows, items, args = [], [], []
    row0, n_rows, n_row_total, n_arg_total = [], [], 0, 0
    for c in schedule.colors:
        p = cg.plans[c]
        vids = p.cv_vid[p.cv_valid].astype(np.int64)
        n = len(vids)
        iv = np.flatnonzero(p.it_valid)
        iv = iv[np.argsort(p.it_row[iv], kind="stable")]
        it_row = p.it_row[iv].astype(np.int64)
        if len(it_row) and it_row.max() >= n:
            raise ValueError("plan of color %d has items on pad rows" % c)
        arity = p.it_arity[iv].astype(np.int64)
        amask = np.arange(p.it_args_vid.shape[1])[None, :] < arity[:, None]
        flags = np.where(upd_v[vids], ROW_UPDATE | ROW_TALLY, 0)
        rows.append(dict(vid=vids, card=var_card[vids],
                         upos=np.asarray(schedule.upos)[vids], flags=flags,
                         count=np.bincount(it_row, minlength=n)))
        items.append(dict(ftype=p.it_ftype[iv], wid=p.it_wid[iv],
                          arity=arity, dense=p.it_dense[iv],
                          d1=p.it_d1[iv], d2=p.it_d2[iv],
                          arg=n_arg_total + np.concatenate(
                              ([0], np.cumsum(arity)[:-1])).astype(
                                  np.int64)))
        args.append(dict(vid=p.it_args_vid[iv][amask],
                         eq=p.it_args_eq[iv][amask],
                         card=p.it_args_card[iv][amask],
                         subst=p.it_subst[iv][amask]))
        row0.append(n_row_total)
        n_rows.append(n)
        n_row_total += n
        n_arg_total += int(arity.sum())

    def cat(parts, key, dtype):
        a = np.concatenate([q[key] for q in parts]) if parts else \
            np.zeros(0)
        return torch.as_tensor(np.ascontiguousarray(a.astype(dtype)),
                               device=device)

    counts = np.concatenate([r["count"] for r in rows]) if rows else \
        np.zeros(0, np.int64)
    row_item = np.concatenate(([0], np.cumsum(counts)))
    if row_item[-1] >= 2 ** 31 or n_arg_total >= 2 ** 31:
        raise ValueError("graph too large for int32 item offsets")
    t = SweepTables(
        kmax=int(cg.kmax), n_vars=int(cg.n_vars),
        n_weights=int(cg.n_weights),
        row_vid=cat(rows, "vid", np.int32),
        row_card=cat(rows, "card", np.int32),
        row_upos=cat(rows, "upos", np.int32),
        row_flags=cat(rows, "flags", np.int8),
        row_item=torch.as_tensor(row_item.astype(np.int32), device=device),
        it_ftype=cat(items, "ftype", np.int32),
        it_wid=cat(items, "wid", np.int32),
        it_arity=cat(items, "arity", np.int32),
        it_arg=cat(items, "arg", np.int32),
        it_dense=cat(items, "dense", np.int8),
        it_d1=cat(items, "d1", np.int32),
        it_d2=cat(items, "d2", np.int32),
        arg_vid=cat(args, "vid", np.int32),
        arg_eq=cat(args, "eq", np.int32),
        arg_card=cat(args, "card", np.int32),
        arg_subst=cat(args, "subst", np.int8),
        row0=row0, n_rows=n_rows,
        map_codes=[MAPS.index(m) for m in schedule.maps],
        draw_codes=[DRAWS.index(d) for d in schedule.draws],
        plans=[cg.plans[c] for c in schedule.colors],
        present=[present_types_of(cg.plans[c].it_ftype)
                 for c in schedule.colors],
    )
    if t.device.type == "cuda":
        t.ptrs = _table_ptrs(t)
    return t


def color_step_reference(t: SweepTables, ci: int, x: torch.Tensor,
                         counts: torch.Tensor, weights: torch.Tensor,
                         seed977: int, epoch: int, tally: bool) -> None:
    """Plain PyTorch version of one kernel launch: resample step ``ci``
    of the sweep in place in ``x`` (V,) and, when ``tally``, add the
    drawn values into ``counts`` (V, K)."""
    lo, n = t.row0[ci], t.n_rows[ci]
    pot = color_potentials(t.plan_tensors(ci), t.plans[ci].kmax,
                           t.present[ci], x, weights)[:n]
    if pot.shape[1] < t.kmax:
        pot = torch.nn.functional.pad(pot, (0, t.kmax - pot.shape[1]))
    vid = t.row_vid[lo:lo + n].to(torch.int64)
    card = t.row_card[lo:lo + n]
    u01 = block_uniforms(seed977, salt16_of(epoch, ci),
                         t.row_upos[lo:lo + n], MAPS[t.map_codes[ci]] ==
                         "tile")
    draw = DRAWS[t.draw_codes[ci]]
    if draw == "sigmoid2":
        new = draw_sigmoid2(pot[:, 0], pot[:, 1], u01)
    elif draw == "vec":
        new = draw_vec(pot, card, t.kmax, u01)
    else:
        new = draw_cdf(pot, card, t.kmax, u01)
    flags = t.row_flags[lo:lo + n]
    upd = (flags & ROW_UPDATE) != 0
    val = torch.where(upd, new.to(x.dtype), x[vid])
    x[vid] = val
    if tally:
        hit = (flags & ROW_TALLY) != 0
        counts[vid[hit], val[hit].to(torch.int64)] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_LIB = None


def _kernel_lib():
    """The built sweep library, with its C signature declared."""
    global _LIB
    if _LIB is None:
        from numbskull_tpu_torch.ops._build import load_library
        lib = load_library("itemgrid_sweep")
        fn = lib.nsx_itemgrid_sweep_color
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        _LIB = lib
    return _LIB


_TABLE_FIELDS = (("row_vid", torch.int32), ("row_card", torch.int32),
                 ("row_upos", torch.int32), ("row_flags", torch.int8),
                 ("row_item", torch.int32), ("it_ftype", torch.int32),
                 ("it_wid", torch.int32), ("it_arity", torch.int32),
                 ("it_arg", torch.int32), ("it_dense", torch.int8),
                 ("it_d1", torch.int32), ("it_d2", torch.int32),
                 ("arg_vid", torch.int32), ("arg_eq", torch.int32),
                 ("arg_card", torch.int32), ("arg_subst", torch.int8))


def _check(name: str, a: torch.Tensor, dtype, device, shape=None):
    if a.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, a.device,
                                                       device))
    if a.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, a.dtype,
                                                           dtype))
    if not a.is_contiguous():
        raise ValueError("%s is not contiguous" % name)
    if shape is not None and tuple(a.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(a.shape), tuple(shape)))


def _table_ptrs(t: SweepTables) -> tuple:
    """Check the tables once, when they are built on the card, and
    return the pointers every launch passes to the kernel."""
    for name, dtype in _TABLE_FIELDS:
        _check(name, getattr(t, name), dtype, t.device)
    if not 1 <= t.kmax <= K_MAX_SUP:
        raise ValueError("kmax %d outside 1..%d" % (t.kmax, K_MAX_SUP))
    return tuple(_ptr(getattr(t, name)) for name, _ in _TABLE_FIELDS)


def _launch_sweep(t: SweepTables, ci: int, x: torch.Tensor,
                  counts: torch.Tensor, weights: torch.Tensor,
                  seed977: int, epoch: int, tally: bool) -> None:
    """Launch the CUDA kernel for step ``ci`` on the current stream. A
    step with no rows launches nothing and counts nothing."""
    global KERNEL_LAUNCHES
    _check("x", x, torch.int32, t.device, (t.n_vars,))
    _check("counts", counts, torch.int32, t.device, (t.n_vars, t.kmax))
    _check("weights", weights, torch.float32, t.device, (t.n_weights,))
    if t.n_rows[ci] == 0:
        return
    if not t.ptrs:
        raise ValueError("sweep tables on %s were not built for the kernel"
                         % t.device)
    fn = _kernel_lib().nsx_itemgrid_sweep_color
    stream = torch.cuda.current_stream(t.device).cuda_stream
    rc = fn(*t.ptrs, _ptr(weights), _ptr(x), _ptr(counts),
            t.row0[ci], t.n_rows[ci], t.kmax, t.map_codes[ci],
            t.draw_codes[ci], seed977, salt16_of(epoch, ci),
            int(bool(tally)), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("itemgrid sweep kernel launch failed: CUDA "
                           "error %d" % rc)
    KERNEL_LAUNCHES += 1


def sweep_color(t: SweepTables, ci: int, x: torch.Tensor,
                counts: torch.Tensor, weights: torch.Tensor, seed977: int,
                epoch: int, tally: bool) -> None:
    """One (epoch, color) step, in place. CPU tensors run the plain
    version; CUDA tensors launch the kernel (errors raise)."""
    if x.device.type == "cpu":
        color_step_reference(t, ci, x, counts, weights, seed977, epoch,
                             tally)
    elif x.device.type == "cuda":
        _launch_sweep(t, ci, x, counts, weights, seed977, epoch, tally)
    else:
        raise ValueError("sweep_color: unsupported device %s" % x.device)


class ItemGridEngine:
    """Fused chromatic Gibbs inference over a CompiledGraph.

    ``run`` sweeps burn-in plus tallied epochs and returns
    ``(values (V,), counts (V, K))`` in original variable order, as
    tensors on ``device``. There is no cap on the epoch count (tallies
    are int32)."""

    def __init__(self, cg: CompiledGraph, sample_evidence: bool = True,
                 device="cpu", schedule: Schedule | None = None):
        device = torch.device(device)
        if cg.kmax > K_MAX_SUP:
            raise ValueError("cardinality %d > %d" % (cg.kmax, K_MAX_SUP))
        self.cg = cg
        self.device = device
        self.schedule = schedule or default_schedule(cg)
        self.tables = build_tables(cg, self.schedule, sample_evidence,
                                   device)

    def run(self, seed: int, burn: int, epochs: int, weight_value=None,
            x0=None):
        cg, dev = self.cg, self.device
        w = cg.weight_init if weight_value is None else weight_value
        w = torch.as_tensor(w, dtype=torch.float32, device=dev).contiguous()
        x = cg.var_init if x0 is None else x0
        x = torch.as_tensor(x, dtype=torch.int32, device=dev).clone()
        counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                             device=dev)
        s977 = seed977_of(seed)
        for epoch in range(burn + epochs):
            for ci in range(self.tables.n_steps):
                sweep_color(self.tables, ci, x, counts, w, s977, epoch,
                            epoch >= burn)
        return x, counts
