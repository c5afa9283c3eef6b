"""Fused chromatic Gibbs sampling and learning: the sweep and learn
kernels, their plain versions, and the engine that drives them.

Port of ``numbskull_tpu/ops/itemgrid_pallas.py`` (``_make_kernel``,
``_make_learn_kernel``, ``PallasItemGridEngine.run`` and ``.learn``) and
of the schedule replay in ``numbskull_tpu/ops/parity.py:37-67``. The TPU
kernels' packed layout, windowed one-hot gathers, color-major
renumbering and int16 tallies existed to work around the TPU's missing
gather and its VMEM cap; none of them is carried over. Values stay in
original variable order on the device, every color's rows and their
items live in flat CSR tables (:func:`build_tables`), and one launch of
``csrc/itemgrid_sweep.cu`` per (epoch, color) resamples a color with one
thread per row. Learning (:func:`learn_color`) launches
``csrc/itemgrid_learn.cu`` three times per (epoch, color): both chains'
draws and per-item gradients, a per-weight reduction in a fixed order,
and the weight update. The graph-sharded engine (``ops/itemgrid_mc.py``)
runs the same kernels on one shard's tables (:func:`build_tables` with
``shard``, :func:`shard_rows`) with the shard's seed and salt
(:func:`mc_seed977_of`, :func:`mc_salt16_of`, :func:`mc_learn_seed_of`),
packs each row's new value for the exchange through the kernels'
optional ``send`` pointers, and in learning replaces the update by a
dense per-shard partial (:func:`learn_color_partial`) and a sum of the
shards' partials in shard order with the update (:func:`learn_apply`).

What is kept exactly are the inputs to every draw and every weight
update, so that a run can be held bit for bit against the TPU kernels'
software-PRNG path:

- the counter hash ``_uniform_sw`` with seed ``int32(seed * 977)``
  (inference) or the raw seed (learning) and salt
  ``int32(int32(epoch * (COLOR_MAX + 1) + ci) * 65536 + block)``,
  XORed with a per-chain constant in learning;
- two position maps: ``row`` (block = upos // 1024, i0 = 0,
  i1 = upos % 1024) and ``tile`` (i0 = (upos % 1024) // 128,
  i1 = upos % 128);
- three draws: ``cdf`` (``_draw``), ``vec`` (``_draw_vec``, a
  Hillis-Steele prefix sum over the global kmax width) and
  ``sigmoid2`` (``_draw2``);
- each row's potentials summed in the order of its items, which a
  schedule may set (``Schedule.arg_rank``).

A :class:`Schedule` says, per step of a sweep, which compile color runs
and with which map and draw, and gives every variable its draw position
``upos``. :func:`default_schedule` is the port's own; the tests derive
one from the JAX package's ``ItemGridPlan`` to compare the two engines.
Learning runs the same colors and positions with the `row` map and the
`cdf` draw on every step, as the TPU learn kernel does.

A step whose color is not independent (``compile.color_variables`` with
``max_colors`` puts the overflow variables in one color, so a row may
read a neighbour of its own color) reads every value from before the
step, as the plain versions do: the kernels read from a snapshot of the
chains taken just before the launch.

:func:`sweep_color` and :func:`learn_color` are the wrappers: CPU
tensors take the plain versions (:func:`color_step_reference`,
:func:`learn_color_step_reference`), CUDA tensors launch the kernels or
raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from numbskull_tpu_torch.compile import CompiledGraph
from numbskull_tpu_torch.ops.factor_eval import present_types_of
from numbskull_tpu_torch.ops.gibbs import (LearnParams, color_potentials,
                                          eval_items_at, plan_tensors)
from numbskull_tpu_torch.types import EV_EVIDENCE, EV_QUERY

COLOR_MAX = 256      # salt stride is COLOR_MAX + 1: at most 256 colors
VEC_K_MIN = 9        # kmax >= this draws with `vec`, below with `cdf`
K_MAX_SUP = 128      # largest cardinality the kernel is built for
RB = 1024            # positions per uniform block

MAPS = ("row", "tile")
DRAWS = ("cdf", "vec", "sigmoid2")

ROW_UPDATE = 1       # row_flags bits (csrc/itemgrid_common.cuh)
ROW_TALLY = 2
ROW_CLAMPED = 4      # the clamped chain resamples the row (query rows)
ROW_EVIDENCE = 8     # the row's items carry the gradient (evidence rows)

BURN_SALT_XOR = 0x40000000      # learning's burn-in draws
CLAMPED_SALT_XOR = 0x55555555   # the clamped chain's draws
WEIGHT_SALT_XOR = 0x33333333    # the L1 truncation coin
LEARN_EPOCH0 = 1 << 16          # salt epoch of learning epoch 0
RED_CHUNK = 1024                # items per chunk of the gradient sum

#: launches of the CUDA sweep kernel in this process; the wrapper adds
#: one where it launches and nowhere else
KERNEL_LAUNCHES = 0
#: launches of the CUDA learn kernels (step, reduce, update)
LEARN_LAUNCHES = 0
#: sweep launches that carry an external potential table (the has_ext
#: form; counted in KERNEL_LAUNCHES too)
EXT_LAUNCHES = 0
#: learn step launches that carry external potential tables (counted in
#: LEARN_LAUNCHES too)
EXT_LEARN_LAUNCHES = 0


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


# Graph-sharded runs (ops/itemgrid_mc.py): shard ``my`` of ``n_g`` draws
# with its own stream, as the multi-chip TPU kernels do. Each step wraps
# in int32; wrapping is arithmetic modulo 2**32, so one final wrap gives
# the same bits.

def mc_seed977_of(seed: int, my: int) -> int:
    """Inference hash seed of shard ``my``: ``int32(seed * 977 + my)``
    (itemgrid_pallas.py:1697)."""
    return _i32(int(seed) * 977 + int(my))


def mc_salt16_of(epoch: int, ci: int, n_g: int, my: int) -> int:
    """Inference salt of shard ``my``'s block 0 of step ``ci``:
    ``int32(int32(int32(epoch * (COLOR_MAX + 1) + ci) * n_g + my) *
    65536)`` (itemgrid_pallas.py:1879); the block index added to it is
    local to the shard. At n_g = 1 it is :func:`salt16_of`."""
    return _i32(((int(epoch) * (COLOR_MAX + 1) + int(ci)) * int(n_g) +
                 int(my)) * 65536)


def mc_learn_seed_of(seed: int, my: int) -> int:
    """Learning draw seed of shard ``my``: ``int32(seed + my)``
    (itemgrid_pallas.py:2134). Learning salts are the single-device
    ones with local block indices, and the L1 coin keeps the base
    seed."""
    return _i32(int(seed) + int(my))


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 ``x``."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def hash_uniforms(seed: int, salt, i0, i1) -> torch.Tensor:
    """``_uniform_sw`` at positions (i0, i1): the counter hash of the
    int32 ``seed``, ``salt`` (int or int32 tensor) and the position.

    int32 arithmetic throughout: multiplication wraps to the low 32
    bits that uint32 would keep, and every right shift is masked to be
    logical."""
    salt = _i32(salt * _H3) if isinstance(salt, int) else salt * _H3
    x = (i0 * _H0) ^ (i1 * _H1) ^ _i32(seed * _H2) ^ salt
    x = (x ^ _lsr(x, 15)) * _H4
    x = (x ^ _lsr(x, 12)) * _H5
    x = x ^ _lsr(x, 15)
    return _lsr(x, 8).to(torch.float32) * (1.0 / (1 << 24))


def block_uniforms(seed977: int, salt16: int, upos: torch.Tensor,
                   tile: bool, salt_xor: int = 0) -> torch.Tensor:
    """The TPU kernel's software uniform at draw positions ``upos``;
    the salt of block b is ``(salt16 + b) ^ salt_xor``."""
    upos = upos.to(torch.int32)
    blk = upos >> 10
    pos = upos & (RB - 1)
    if tile:
        i0, i1 = pos >> 7, pos & 127
    else:
        i0, i1 = torch.zeros_like(pos), pos
    salt = (blk + salt16) ^ _i32(salt_xor)
    return hash_uniforms(seed977, salt, i0, i1)


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
    variable's draw position within its color. A row sums its items in
    plan order, or, given ``arg_rank`` (V,), in ascending order of the
    smallest ``arg_rank`` among each item's gathered arguments (items
    that gather nothing last, ties in plan order): the slot order of the
    TPU kernel when ``arg_rank`` is its plan's ``perm``."""

    colors: tuple
    maps: tuple
    draws: tuple
    upos: np.ndarray
    arg_rank: np.ndarray | None = None

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
    arrays. ``plans`` keeps each step's ColorPlan and ``item_index`` the
    plan items of each step in table order, from which the plain
    versions compute their potentials (:meth:`plan_tensors`, built on
    first use, so a kernel-only run never uploads them). ``conflict``
    marks the steps whose color is not independent."""

    kmax: int
    n_vars: int
    n_weights: int
    row_vid: torch.Tensor      # (N,) int32
    row_card: torch.Tensor     # (N,) int32
    row_upos: torch.Tensor     # (N,) int32
    row_flags: torch.Tensor    # (N,) int8: ROW_* bits
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
    item_index: list           # per step: its plan items, in table order
    item0: list                # per step: first item
    conflict: list             # per step: a row gathers its own color
    present: list              # per step: factor codes present
    row_index: list = None     # per step: the table rows' color ranks
    #                            (a shard's tables); None: all, in order
    ptrs: tuple = ()           # the kernel's table pointers (CUDA only)
    _plan_tensors: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.row_vid.device

    @property
    def n_steps(self) -> int:
        return len(self.row0)

    def plan_tensors(self, ci: int) -> dict:
        """Step ``ci``'s plan tensors on the tables' device, its items in
        table order."""
        if ci not in self._plan_tensors:
            self._plan_tensors[ci] = plan_tensors(
                self.plans[ci], self.device, items=self.item_index[ci],
                rows=None if self.row_index is None else
                self.row_index[ci])
        return self._plan_tensors[ci]


_NO_RANK = np.int64(1) << 62


def shard_rows(upos: np.ndarray, n_g: int, d: int):
    """The split rule of ``shard_schedule`` (itemgrid_pallas.py:3130):
    of a step whose rows have draw positions ``upos``, shard ``d`` of
    ``n_g`` owns the rows with a position in ``[d*nb*RB, (d+1)*nb*RB)``,
    ``nb = ceil(len(upos) / (n_g*RB))`` blocks. Returns (the owned rows'
    indices in step order, the shard's first position ``d*nb*RB``)."""
    upos = np.asarray(upos, np.int64)
    nb = -(-len(upos) // (n_g * RB))
    if len(upos) and upos.max() >= nb * n_g * RB:
        raise ValueError("draw position %d beyond the %d x %d blocks of "
                         "the shards" % (upos.max(), n_g, nb))
    lo = d * nb * RB
    return np.flatnonzero((upos >= lo) & (upos < lo + nb * RB)), lo


def build_tables(cg: CompiledGraph, schedule: Schedule,
                 sample_evidence: bool, device,
                 shard: tuple | None = None) -> SweepTables:
    """Flatten ``cg.plans`` in schedule order into CSR tables on
    ``device``. A row may update when it is a query variable, or an
    evidence variable under ``sample_evidence``; it is tallied iff it
    may update (itemgrid_pallas.py:426-427). For learning, the clamped
    chain resamples query rows and the gradient comes from evidence
    rows (itemgrid_pallas.py:738-739). A step is marked ``conflict``
    when an item of one of its rows gathers an argument of the step's
    own color.

    ``shard=(d, n_g)`` keeps only shard d's rows of every step
    (:func:`shard_rows`), with their items and arguments, and makes
    their draw positions local to the shard."""
    var_card = np.asarray(cg.var_card, np.int64)
    isev = np.asarray(cg.var_isev, np.int64)
    color_of = np.asarray(cg.color_of, np.int64)
    upd_v = (isev == EV_QUERY) | (bool(sample_evidence) &
                                  (isev == EV_EVIDENCE))
    row_bits = (np.where(upd_v, ROW_UPDATE | ROW_TALLY, 0) |
                np.where(isev == EV_QUERY, ROW_CLAMPED, 0) |
                np.where(isev == EV_EVIDENCE, ROW_EVIDENCE, 0))
    rank = None if schedule.arg_rank is None else \
        np.asarray(schedule.arg_rank, np.int64)
    upos_all = np.asarray(schedule.upos, np.int64)
    rows, items, args = [], [], []
    row0, n_rows, n_row_total, n_arg_total = [], [], 0, 0
    item_index, item0, conflict, n_item_total = [], [], [], 0
    row_index = [] if shard is not None else None
    for c in schedule.colors:
        p = cg.plans[c]
        vids = p.cv_vid[p.cv_valid].astype(np.int64)
        iv = np.flatnonzero(p.it_valid)
        it_local = p.it_row
        lo = 0
        if shard is not None:
            sel, lo = shard_rows(upos_all[vids], shard[1], shard[0])
            local = np.full(len(vids) + 1, -1, np.int64)
            local[sel] = np.arange(len(sel))
            iv = iv[local[np.minimum(p.it_row[iv], len(vids))] >= 0]
            it_local = local[np.minimum(p.it_row, len(vids))]
            vids = vids[sel]
            row_index.append(sel)
        n = len(vids)
        gathered = p.it_args_valid[iv] & ~p.it_subst[iv]
        avid = p.it_args_vid[iv].astype(np.int64)
        if rank is None:
            iv = iv[np.argsort(it_local[iv], kind="stable")]
        else:
            key = np.where(gathered, rank[avid], _NO_RANK).min(axis=1) \
                if len(iv) else np.zeros(0, np.int64)
            iv = iv[np.lexsort((key, it_local[iv]))]
        conflict.append(bool((color_of[avid[gathered]] == c).any()))
        it_row = np.asarray(it_local[iv], np.int64)
        if len(it_row) and it_row.max() >= n:
            raise ValueError("plan of color %d has items on pad rows" % c)
        arity = p.it_arity[iv].astype(np.int64)
        amask = np.arange(p.it_args_vid.shape[1])[None, :] < arity[:, None]
        rows.append(dict(vid=vids, card=var_card[vids],
                         upos=upos_all[vids] - lo,
                         flags=row_bits[vids],
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
        item_index.append(iv)
        item0.append(n_item_total)
        n_row_total += n
        n_arg_total += int(arity.sum())
        n_item_total += len(iv)

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
    # the salt adds the block index upos >> 10 below 65536 (salt16_of)
    if any(len(r["upos"]) and r["upos"].max() >= RB << 16 for r in rows):
        raise ValueError("a color has a draw position >= %d: its block "
                         "index would overflow the salt's 16 bits"
                         % (RB << 16))
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
        item_index=item_index, item0=item0, conflict=conflict,
        present=[present_types_of(cg.plans[c].it_ftype)
                 for c in schedule.colors],
        row_index=row_index,
    )
    if t.device.type == "cuda":
        t.ptrs = _table_ptrs(t)
    return t


def color_step_reference(t: SweepTables, ci: int, x: torch.Tensor,
                         counts: torch.Tensor, weights: torch.Tensor,
                         seed977: int, epoch: int, tally: bool,
                         salt_xor: int = 0, salt16: int | None = None,
                         send: torch.Tensor | None = None,
                         ext: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of one kernel launch: resample step ``ci``
    of the sweep in place in ``x`` (V,) and, when ``tally``, add the
    drawn values into ``counts`` (V, K). Every value is read before any
    is written. ``salt16`` replaces ``salt16_of(epoch, ci)`` (a shard's
    stream); ``send`` receives the rows' values after the step, in row
    order (the packed half of the exchange); ``ext`` (V, K') adds
    external potentials before the draw (:func:`_padded_potentials`)."""
    lo, n = t.row0[ci], t.n_rows[ci]
    pot = _padded_potentials(t, ci, x, weights, ext)
    vid = t.row_vid[lo:lo + n].to(torch.int64)
    card = t.row_card[lo:lo + n]
    u01 = block_uniforms(seed977, salt16_of(epoch, ci) if salt16 is None
                         else salt16, t.row_upos[lo:lo + n],
                         MAPS[t.map_codes[ci]] == "tile", salt_xor)
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
    if send is not None:
        send[:n] = val
    if tally:
        hit = (flags & ROW_TALLY) != 0
        counts[vid[hit], val[hit].to(torch.int64)] += 1


def _padded_potentials(t: SweepTables, ci: int, x: torch.Tensor,
                       weights: torch.Tensor,
                       ext: torch.Tensor | None = None) -> torch.Tensor:
    """Step ``ci``'s potentials (n_rows, t.kmax) from values ``x``; with
    ``ext`` (V, K'), each row's ``ext[vid, k]`` is added after its items
    (itemgrid_pallas.py:1862-1868) for k below the color's kmax: the
    columns above it are beyond every row's cardinality, which each draw
    masks, so the kernel's adding them up to the global kmax draws the
    same values."""
    pot = color_potentials(t.plan_tensors(ci), t.plans[ci].kmax,
                           t.present[ci], x, weights, ext)[:t.n_rows[ci]]
    if pot.shape[1] < t.kmax:
        pot = torch.nn.functional.pad(pot, (0, t.kmax - pot.shape[1]))
    return pot


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_LIBS = {}


def _kernel_lib(name: str = "itemgrid_sweep"):
    """The built library ``csrc/<name>.cu``, with its C signatures
    declared."""
    if name not in _LIBS:
        from numbskull_tpu_torch.ops._build import load_library
        lib = load_library(name)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "itemgrid_sweep":
            sigs = {"nsx_itemgrid_sweep_color": [P] * 22 + [I] * 9 + [P]}
        elif name == "itemgrid_exchange":
            sigs = {"nsx_exchange_unpack": [P] * 5 + [I] * 6 + [P]}
        else:
            sigs = {"nsx_learn_step": [P] * 28 + [I] * 7 + [P],
                    "nsx_learn_reduce": [P] * 7 + [I] * 2 + [P],
                    "nsx_learn_update": [P] * 7 + [I] * 4 + [F] * 4 +
                    [I] * 2 + [P],
                    "nsx_learn_partial": [P] * 7 + [I] * 3 + [P],
                    "nsx_learn_apply": [P] * 3 + [I] * 6 + [F] * 4 +
                    [I] * 2 + [P]}
        for fn_name, argtypes in sigs.items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _LIBS[name] = lib
    return _LIBS[name]


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


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (what, rc))


def _send_ptr(name: str, send, device, n: int):
    """The pointer of a pack buffer of at least ``n`` int32 values, or
    NULL when there is none."""
    if send is None:
        return ctypes.c_void_p(None)
    _check(name, send, torch.int32, device)
    if send.dim() != 1 or send.numel() < n:
        raise ValueError("%s holds %d values, the step has %d rows"
                         % (name, send.numel(), n))
    return _ptr(send)


def _ext_ptr(name: str, ext, device, n_vars: int):
    """The pointer and width of an external potential table (V, K')
    float32, or (NULL, 0) when there is none."""
    if ext is None:
        return ctypes.c_void_p(None), 0
    _check(name, ext, torch.float32, device)
    if ext.dim() != 2 or ext.shape[0] != n_vars or ext.shape[1] < 1:
        raise ValueError("%s has shape %s, expected (%d, K >= 1)"
                         % (name, tuple(ext.shape), n_vars))
    return _ptr(ext), int(ext.shape[1])


def _launch_sweep(t: SweepTables, ci: int, x: torch.Tensor,
                  counts: torch.Tensor, weights: torch.Tensor,
                  seed977: int, salt16: int, tally: bool,
                  send: torch.Tensor | None = None,
                  ext: torch.Tensor | None = None) -> None:
    """Launch the CUDA kernel for step ``ci`` on the current stream. A
    step with no rows launches nothing and counts nothing; a
    conflicting step reads from a snapshot of ``x``. With ``send``, the
    kernel also writes each row's value after the step to
    ``send[row - row0]``; with ``ext`` (V, K') it adds each row's
    external potentials before the draw."""
    global KERNEL_LAUNCHES, EXT_LAUNCHES
    _check("x", x, torch.int32, t.device, (t.n_vars,))
    _check("counts", counts, torch.int32, t.device, (t.n_vars, t.kmax))
    _check("weights", weights, torch.float32, t.device, (t.n_weights,))
    send_p = _send_ptr("send", send, t.device, t.n_rows[ci])
    ext_p, kext = _ext_ptr("ext", ext, t.device, t.n_vars)
    if t.n_rows[ci] == 0:
        return
    if not t.ptrs:
        raise ValueError("sweep tables on %s were not built for the kernel"
                         % t.device)
    xr = x.clone() if t.conflict[ci] else x
    fn = _kernel_lib().nsx_itemgrid_sweep_color
    rc = fn(*t.ptrs, _ptr(weights), _ptr(xr), _ptr(x), _ptr(counts),
            send_p, ext_p, t.row0[ci], t.n_rows[ci], t.kmax,
            t.map_codes[ci], t.draw_codes[ci], seed977, salt16,
            int(bool(tally)), kext, _stream(t.device))
    _raise_if(rc, "itemgrid sweep kernel")
    KERNEL_LAUNCHES += 1
    EXT_LAUNCHES += ext is not None


def sweep_color(t: SweepTables, ci: int, x: torch.Tensor,
                counts: torch.Tensor, weights: torch.Tensor, seed977: int,
                epoch: int, tally: bool, salt_xor: int = 0,
                salt16: int | None = None,
                send: torch.Tensor | None = None,
                ext: torch.Tensor | None = None) -> None:
    """One (epoch, color) step, in place. CPU tensors run the plain
    version; CUDA tensors launch the kernel (errors raise).
    ``salt_xor`` (learning's burn-in) must leave the low 16 bits of the
    salt alone, where it commutes with adding the block index.
    ``salt16`` replaces ``salt16_of(epoch, ci)``, ``send`` receives
    the rows' values after the step and ``ext`` (V, K') adds external
    potentials before the draw (see :func:`color_step_reference`)."""
    if salt_xor & 0xFFFF:
        raise ValueError("salt_xor 0x%x touches the block bits" % salt_xor)
    if x.device.type == "cpu":
        color_step_reference(t, ci, x, counts, weights, seed977, epoch,
                             tally, salt_xor, salt16, send, ext)
    elif x.device.type == "cuda":
        s16 = salt16_of(epoch, ci) if salt16 is None else salt16
        _launch_sweep(t, ci, x, counts, weights, seed977,
                      _i32(s16 ^ salt_xor), tally, send, ext)
    else:
        raise ValueError("sweep_color: unsupported device %s" % x.device)


# ---- learning ------------------------------------------------------------

@dataclasses.dataclass
class LearnTables:
    """What learning adds to a graph's SweepTables, built on first use
    so that inference-only runs upload nothing of it.

    ``sweep`` is the tables under the learn schedule (every step `row`
    and `cdf`; the tensors are shared). The gradient of step ci sums,
    per weight, the step's items in a fixed order: ``red_item`` lists
    each step's items sorted by (weight, item); each weight's run is cut
    into chunks of at most RED_CHUNK (``ch_start``, ``ch_len``), and
    ``wt_*`` name, per step, each weight with items and its chunks."""

    sweep: SweepTables
    it_fv: torch.Tensor        # (I,) float32 featureValue
    w_fixed: torch.Tensor      # (W,) int8
    red_item: torch.Tensor     # (I,) int32 item ids, by (step, wid, item)
    ch_start: torch.Tensor     # (NC,) int32 first entry in red_item
    ch_len: torch.Tensor       # (NC,) int32
    wt_wid: torch.Tensor       # (NW,) int32 weight id
    wt_ch0: torch.Tensor       # (NW,) int32 first chunk
    wt_nch: torch.Tensor       # (NW,) int32 chunk count
    ch0: list                  # per step: first chunk
    n_ch: list                 # per step: chunk count
    wt0: list                  # per step: first weight entry
    n_wt: list                 # per step: weight entries
    item_g: torch.Tensor       # (I,) float32 scratch: per-item gradient
    item_inc: torch.Tensor     # (I,) int8 scratch: item counted
    chunk_g: torch.Tensor      # (NC,) float32 scratch: chunk sums
    chunk_n: torch.Tensor      # (NC,) int32 scratch: chunk counts
    host: dict                 # numpy copies of red_item, ch_*, wt_*
    ptrs: dict = dataclasses.field(default_factory=dict)
    _plain: dict = dataclasses.field(default_factory=dict)


def build_learn_tables(t: SweepTables, weight_fixed) -> LearnTables:
    """The learn tables of ``t`` on its device."""
    dev = t.device
    fv = [np.asarray(p.it_fv)[iv] for p, iv in zip(t.plans, t.item_index)]
    wid = [np.asarray(p.it_wid)[iv].astype(np.int64)
           for p, iv in zip(t.plans, t.item_index)]
    red, ch_s, ch_l, w_w, w_c0, w_n = [], [], [], [], [], []
    ch0, n_ch, wt0, n_wt, nc, nw = [], [], [], [], 0, 0
    for ci, wl in enumerate(wid):
        lo = t.item0[ci]
        order = np.argsort(wl, kind="stable")
        uw, first, cnt = np.unique(wl[order], return_index=True,
                                   return_counts=True)
        nch = -(-cnt // RED_CHUNK)
        rep = np.repeat(np.arange(len(uw)), nch)
        within = np.arange(int(nch.sum())) - np.repeat(np.cumsum(nch) - nch,
                                                       nch)
        starts = first[rep] + within * RED_CHUNK
        red.append(lo + order)
        ch_s.append(lo + starts)
        ch_l.append(np.minimum(RED_CHUNK, first[rep] + cnt[rep] - starts))
        w_w.append(uw)
        w_c0.append(nc + np.cumsum(nch) - nch)
        w_n.append(nch)
        ch0.append(nc)
        n_ch.append(int(nch.sum()))
        wt0.append(nw)
        n_wt.append(len(uw))
        nc += n_ch[-1]
        nw += n_wt[-1]

    def cat(parts, dtype):
        a = np.concatenate(parts) if parts else np.zeros(0)
        return np.ascontiguousarray(a.astype(dtype))

    host = dict(red_item=cat(red, np.int32), ch_start=cat(ch_s, np.int32),
                ch_len=cat(ch_l, np.int32), wt_wid=cat(w_w, np.int32),
                wt_ch0=cat(w_c0, np.int32), wt_nch=cat(w_n, np.int32))
    n_items = t.item0[-1] + len(t.item_index[-1]) if t.n_steps else 0

    def up(a):
        return torch.as_tensor(a, device=dev)

    lt = LearnTables(
        sweep=dataclasses.replace(t, map_codes=[MAPS.index("row")] *
                                  t.n_steps,
                                  draw_codes=[DRAWS.index("cdf")] *
                                  t.n_steps),
        it_fv=up(cat(fv, np.float32)),
        w_fixed=up(np.asarray(weight_fixed).astype(np.int8)),
        **{k: up(v) for k, v in host.items()},
        ch0=ch0, n_ch=n_ch, wt0=wt0, n_wt=n_wt,
        item_g=torch.zeros(n_items, dtype=torch.float32, device=dev),
        item_inc=torch.zeros(n_items, dtype=torch.int8, device=dev),
        chunk_g=torch.zeros(nc, dtype=torch.float32, device=dev),
        chunk_n=torch.zeros(nc, dtype=torch.int32, device=dev),
        host=host)
    if dev.type == "cuda":
        lt.ptrs = {name: _ptr(getattr(lt, name)) for name in (
            "it_fv", "w_fixed", "red_item", "ch_start", "ch_len", "wt_wid",
            "wt_ch0", "wt_nch", "item_g", "item_inc", "chunk_g", "chunk_n")}
    return lt


@dataclasses.dataclass(frozen=True)
class LearnStep:
    """One learning epoch's update constants: float32 values (exact as
    Python floats), computed on the host once per epoch in torch
    float32 as the TPU kernel computes them (itemgrid_pallas.py:
    2500-2518, 2765-2766), and shared by the kernel and the plain
    version."""

    step: float        # step0 * exp(f32(i) * log(decay))
    shrink: float      # L2: 1 / fma(reg_param, step, 1)
    l1d: float         # L1: reg_param * step * truncation
    thresh: float      # L1: truncate where the coin < 1 / truncation
    regularization: int
    mean: bool
    learn_non_evidence: bool


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as an IEEE fma (CUDA's
    ``__fmaf_rn``), for float32 tensors or numbers.

    The interpret-mode TPU kernel runs on XLA's CPU backend, which
    contracts ``w * shrink - step * g``, ``w - step * g`` and
    ``1 + reg * step`` into fmas; the port computes the same fmas. The
    product is exact in float64; the sum is rounded to odd in float64
    (its error from a TwoSum decides the last bit), after which rounding
    to float32 is the correctly rounded fma."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float32).double()
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def learn_step_of(lp: LearnParams, stepsize: float, decay: float,
                  i: int) -> LearnStep:
    """The constants of learning epoch ``i``."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32)

    step = f(stepsize) * torch.exp(f(float(i)) * torch.log(f(decay)))
    reg = f(lp.reg_param)
    return LearnStep(
        step=float(step),
        shrink=float(f(1.0) / fma32(reg, step, 1.0)),
        l1d=float(reg * step * f(float(lp.truncation))),
        thresh=float(f(1.0 / lp.truncation)),
        regularization=int(lp.regularization),
        mean=lp.grad_agg == "mean",
        learn_non_evidence=bool(lp.learn_non_evidence))


def _coin_salt(epoch: int, ci: int) -> int:
    """The salt of step ``ci``'s L1 coin (the draws use salt16_of)."""
    return _i32(_i32(int(epoch) * (COLOR_MAX + 1) + int(ci)) ^
                WEIGHT_SALT_XOR)


def learn_color_step_reference(lt: LearnTables, ci: int, x: torch.Tensor,
                               xe: torch.Tensor, w: torch.Tensor,
                               seed: int, epoch: int, hs: LearnStep,
                               ext_p: torch.Tensor | None = None,
                               ext_e: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of one learn step (the three kernel
    launches): both chains of step ``ci`` resample in place in ``x``
    (free) and ``xe`` (clamped), then the weights ``w`` take one SGD
    step, in place.

    Every value is read before any is written: both chains' potentials,
    then the `cdf` draws at the global kmax, then each item evaluated at
    the two drawn values with its other arguments from before the step.
    An item counts when its row carries the gradient and it is dense or
    a drawn value hits its d1/d2 slot; its gradient is (eval at the free
    value - eval at the clamped value) x featureValue. Per weight the
    gradients sum in the kernels' order (:func:`_weight_sums`).
    ``ext_p`` / ``ext_e`` (V, K') add external potentials to the free /
    clamped chain's potentials before the draws."""
    if lt.sweep.n_rows[ci] == 0:
        return
    gsum, nsum = learn_rows_reference(lt, ci, x, xe, w, seed, epoch, hs,
                                      ext_p=ext_p, ext_e=ext_e)
    a, m = lt.wt0[ci], lt.n_wt[ci]
    _update_weights_reference(w, lt.wt_wid[a:a + m].to(torch.int64), gsum,
                              nsum, lt.w_fixed, seed,
                              _coin_salt(epoch, ci), hs)


def learn_rows_reference(lt: LearnTables, ci: int, x: torch.Tensor,
                         xe: torch.Tensor, w: torch.Tensor, seed: int,
                         epoch: int, hs: LearnStep,
                         send: torch.Tensor | None = None,
                         send_e: torch.Tensor | None = None,
                         ext_p: torch.Tensor | None = None,
                         ext_e: torch.Tensor | None = None):
    """Both chains' half of :func:`learn_color_step_reference` (the step
    and reduce kernels): resample step ``ci`` in place and return, per
    weight of the step (``wt_wid`` order), the gradient sum and count.
    ``send`` / ``send_e`` receive the rows' values of each chain after
    the step, in row order; ``ext_p`` / ``ext_e`` are added to the free
    / clamped chain's potentials after the items
    (itemgrid_pallas.py:2351-2360)."""
    t = lt.sweep
    lo, n = t.row0[ci], t.n_rows[ci]
    pd = t.plan_tensors(ci)
    pot_p = _padded_potentials(t, ci, x, w, ext_p)
    pot_e = _padded_potentials(t, ci, xe, w, ext_e)
    vid = t.row_vid[lo:lo + n].to(torch.int64)
    card = t.row_card[lo:lo + n]
    upos = t.row_upos[lo:lo + n]
    salt16 = salt16_of(epoch, ci)
    e_new = draw_cdf(pot_e, card, t.kmax, block_uniforms(
        seed, salt16, upos, False, CLAMPED_SALT_XOR))
    p_new = draw_cdf(pot_p, card, t.kmax, block_uniforms(
        seed, salt16, upos, False))
    flags = t.row_flags[lo:lo + n]
    upd = (flags & ROW_UPDATE) != 0
    lrn = upd if hs.learn_non_evidence else (flags & ROW_EVIDENCE) != 0
    p_val = torch.where(upd, p_new.to(x.dtype), x[vid])
    e_val = torch.where((flags & ROW_CLAMPED) != 0, e_new.to(xe.dtype),
                        xe[vid])

    row = pd["it_row"]
    p_it, e_it = p_val[row], e_val[row]
    ev_p = eval_items_at(pd, t.present[ci], x, p_it)
    ev_e = eval_items_at(pd, t.present[ci], xe, e_it)
    hit = (pd["it_d1"] == e_it) | (pd["it_d1"] == p_it) | \
        (pd["it_d2"] == e_it) | (pd["it_d2"] == p_it)
    inc = lrn[row] & (pd["it_dense"] | hit)
    grad = torch.where(inc, (ev_p - ev_e) * pd["it_fv"],
                       torch.zeros((), dtype=torch.float32,
                                   device=x.device))
    x[vid] = p_val
    xe[vid] = e_val
    if send is not None:
        send[:n] = p_val
    if send_e is not None:
        send_e[:n] = e_val
    return _weight_sums(lt, ci, grad, inc.to(torch.int32))


def _update_weights_reference(w: torch.Tensor, wid: torch.Tensor,
                              gsum: torch.Tensor, nsum: torch.Tensor,
                              w_fixed: torch.Tensor, seed: int, salt_w: int,
                              hs: LearnStep) -> None:
    """One SGD step of weights ``wid`` (int64) in ``w``, in place, from
    their gradient sums and counts; weights counted by no item, and
    fixed weights, keep their value. The L1 coin hashes ``seed``."""
    touched = (nsum > 0) & (w_fixed[wid] == 0)
    if hs.mean:
        gsum = gsum / torch.clamp(nsum.to(torch.float32), min=1.0)
    wv = w[wid]
    if hs.regularization == 2:
        new = fma32(wv, hs.shrink, -(hs.step * gsum))
    else:
        new = fma32(-hs.step, gsum, wv)
        if hs.regularization == 1:
            zero = torch.zeros((), dtype=torch.float32, device=w.device)
            trunc = torch.where(new > 0,
                                torch.maximum(zero, new - hs.l1d),
                                torch.minimum(zero, new + hs.l1d))
            wi = wid.to(torch.int32)
            u = hash_uniforms(seed, salt_w, wi >> 7, wi & 127)
            new = torch.where(u < hs.thresh, trunc, new)
    w[wid] = torch.where(touched, new, wv)


def learn_color_partial_reference(lt: LearnTables, ci: int,
                                  x: torch.Tensor, xe: torch.Tensor,
                                  w: torch.Tensor, seed: int, epoch: int,
                                  hs: LearnStep, part: torch.Tensor,
                                  send: torch.Tensor | None = None,
                                  send_e: torch.Tensor | None = None,
                                  ext_p: torch.Tensor | None = None,
                                  ext_e: torch.Tensor | None = None) -> None:
    """Plain version of :func:`learn_color_partial` (the step, reduce
    and partial kernels): the shard's per-weight sums of step ``ci`` as
    dense vectors, ``part`` (2W,) int32 = (gradient sums as float32
    bits, counts), zero for weights not in the step."""
    W = lt.w_fixed.numel()
    part.zero_()
    if lt.sweep.n_rows[ci] == 0:
        return
    gsum, nsum = learn_rows_reference(lt, ci, x, xe, w, seed, epoch, hs,
                                      send, send_e, ext_p, ext_e)
    a, m = lt.wt0[ci], lt.n_wt[ci]
    wid = lt.wt_wid[a:a + m].to(torch.int64)
    part[:W].view(torch.float32)[wid] = gsum
    part[W:2 * W][wid] = nsum


def learn_apply_reference(payload: torch.Tensor, goff: int,
                          w_fixed: torch.Tensor, w: torch.Tensor,
                          seed: int, epoch: int, ci: int,
                          hs: LearnStep) -> None:
    """Plain version of the apply kernel: every shard's partial of step
    ``ci`` (``payload`` (n_g, stride) int32, the partial at ``goff``)
    added in shard order 0..n_g-1 from 0.0 (itemgrid_pallas.py:
    2486-2493), then one SGD step of every weight, in place; the L1
    coin hashes the base ``seed``, so every shard applies the same
    update."""
    W = w.numel()
    g = torch.zeros(W, dtype=torch.float32, device=w.device)
    n = torch.zeros(W, dtype=torch.int32, device=w.device)
    for d in range(payload.shape[0]):
        g = g + payload[d, goff:goff + W].view(torch.float32)
        n = n + payload[d, goff + W:goff + 2 * W]
    _update_weights_reference(
        w, torch.arange(W, device=w.device), g, n, w_fixed, seed,
        _coin_salt(epoch, ci), hs)


def _weight_sums(lt: LearnTables, ci: int, grad: torch.Tensor,
                 inc: torch.Tensor):
    """Per weight of step ``ci`` (``wt_wid`` order): the sum of its
    items' gradients and their count, added in the order of the reduce
    and update kernels. A chunk of up to RED_CHUNK items, padded with
    zeros, is a (32, 32) block: lane l adds entries j * 32 + l for j in
    order, then the 32 lane sums halve pairwise (l + h into l, h = 16,
    8, 4, 2, 1). A weight adds its chunk sums in chunk order. Explicit
    elementwise adds only: index_add_ and sum leave the order open."""
    dev = grad.device
    if ci not in lt._plain:
        h = lt.host
        c0, nc = lt.ch0[ci], lt.n_ch[ci]
        item_lo = lt.sweep.item0[ci]
        j = np.arange(RED_CHUNK)[None, :]
        starts = h["ch_start"][c0:c0 + nc].astype(np.int64)[:, None]
        lens = h["ch_len"][c0:c0 + nc].astype(np.int64)[:, None]
        pos = np.minimum(starts + j, len(h["red_item"]) - 1)
        idx = np.where(j < lens, h["red_item"][pos].astype(np.int64) -
                       item_lo, -1)
        a, m = lt.wt0[ci], lt.n_wt[ci]
        wc0 = h["wt_ch0"][a:a + m].astype(np.int64) - c0
        wnc = h["wt_nch"][a:a + m].astype(np.int64)
        lt._plain[ci] = tuple(torch.as_tensor(v, device=dev)
                              for v in (idx, wc0, wnc))
    idx, wc0, wnc = lt._plain[ci]
    if not len(wc0):
        return (torch.zeros(0, dtype=torch.float32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    pad = idx < 0
    g = torch.where(pad, 0.0, grad[idx.clamp(min=0)]).view(-1, 32, 32)
    c = torch.where(pad, 0, inc[idx.clamp(min=0)]).view(-1, 32, 32)
    acc = torch.zeros_like(g[:, 0, :])
    cnt = torch.zeros_like(c[:, 0, :])
    for jj in range(32):
        acc = acc + g[:, jj, :]
        cnt = cnt + c[:, jj, :]
    h = 16
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        cnt = cnt[:, :h] + cnt[:, h:2 * h]
        h //= 2
    acc, cnt = acc[:, 0], cnt[:, 0]
    gsum, nsum = acc[wc0], cnt[wc0]
    for k in range(1, int(wnc.max())):
        more = k < wnc
        at = torch.where(more, wc0 + k, wc0)
        gsum = torch.where(more, gsum + acc[at], gsum)
        nsum = torch.where(more, nsum + cnt[at], nsum)
    return gsum, nsum


def _launch_learn_rows(lt: LearnTables, ci: int, x: torch.Tensor,
                       xe: torch.Tensor, w: torch.Tensor, seed: int,
                       epoch: int, hs: LearnStep, send=None,
                       send_e=None, ext_p=None, ext_e=None) -> bool:
    """The step and reduce launches of one learn step on the current
    stream; returns False, launching nothing, for a step with no rows.
    A launch with no chunks to work on is skipped and not counted. A
    conflicting step reads from snapshots of the chains. ``ext_p`` /
    ``ext_e`` (V, K'), of one width, add external potentials to the
    free / clamped chain before the draws."""
    global LEARN_LAUNCHES, EXT_LEARN_LAUNCHES
    t = lt.sweep
    _check("x", x, torch.int32, t.device, (t.n_vars,))
    _check("xe", xe, torch.int32, t.device, (t.n_vars,))
    _check("weights", w, torch.float32, t.device, (t.n_weights,))
    send_p = _send_ptr("send", send, t.device, t.n_rows[ci])
    send_e_p = _send_ptr("send_e", send_e, t.device, t.n_rows[ci])
    ext_pp, kext = _ext_ptr("ext_p", ext_p, t.device, t.n_vars)
    ext_ep, kext_e = _ext_ptr("ext_e", ext_e, t.device, t.n_vars)
    if ext_p is not None and ext_e is not None and kext != kext_e:
        raise ValueError("ext_p and ext_e differ in width: %d, %d"
                         % (kext, kext_e))
    kext = kext or kext_e
    if t.n_rows[ci] == 0:
        return False
    if not t.ptrs or not lt.ptrs:
        raise ValueError("learn tables on %s were not built for the kernel"
                         % t.device)
    lib, p = _kernel_lib("itemgrid_learn"), lt.ptrs
    stream = _stream(t.device)
    xr, xer = (x.clone(), xe.clone()) if t.conflict[ci] else (x, xe)
    _raise_if(lib.nsx_learn_step(
        *t.ptrs, p["it_fv"], _ptr(w), _ptr(x), _ptr(xe), _ptr(xr),
        _ptr(xer), p["item_g"], p["item_inc"], send_p, send_e_p, ext_pp,
        ext_ep, t.row0[ci], t.n_rows[ci], t.kmax, seed,
        salt16_of(epoch, ci), int(hs.learn_non_evidence), kext, stream),
        "learn step kernel")
    LEARN_LAUNCHES += 1
    EXT_LEARN_LAUNCHES += ext_p is not None or ext_e is not None
    if lt.n_ch[ci]:
        _raise_if(lib.nsx_learn_reduce(
            p["red_item"], p["ch_start"], p["ch_len"], p["item_g"],
            p["item_inc"], p["chunk_g"], p["chunk_n"], lt.ch0[ci],
            lt.n_ch[ci], stream), "learn reduce kernel")
        LEARN_LAUNCHES += 1
    return True


def _launch_learn(lt: LearnTables, ci: int, x: torch.Tensor,
                  xe: torch.Tensor, w: torch.Tensor, seed: int, epoch: int,
                  hs: LearnStep, ext_p=None, ext_e=None) -> None:
    """The three CUDA launches of one learn step on the current stream;
    a launch with no rows, chunks or weights to work on is skipped and
    not counted."""
    global LEARN_LAUNCHES
    if not _launch_learn_rows(lt, ci, x, xe, w, seed, epoch, hs,
                              ext_p=ext_p, ext_e=ext_e) or \
            not lt.n_wt[ci]:
        return
    p = lt.ptrs
    _raise_if(_kernel_lib("itemgrid_learn").nsx_learn_update(
        p["wt_wid"], p["wt_ch0"], p["wt_nch"], p["chunk_g"],
        p["chunk_n"], p["w_fixed"], _ptr(w), lt.wt0[ci], lt.n_wt[ci],
        int(hs.mean), hs.regularization, hs.step, hs.shrink, hs.l1d,
        hs.thresh, seed, _coin_salt(epoch, ci),
        _stream(lt.sweep.device)), "learn update kernel")
    LEARN_LAUNCHES += 1


def learn_color_partial(lt: LearnTables, ci: int, x: torch.Tensor,
                        xe: torch.Tensor, w: torch.Tensor, seed: int,
                        epoch: int, hs: LearnStep, part: torch.Tensor,
                        send: torch.Tensor | None = None,
                        send_e: torch.Tensor | None = None,
                        ext_p: torch.Tensor | None = None,
                        ext_e: torch.Tensor | None = None) -> None:
    """A shard's half of one learn step, in place: both chains of step
    ``ci`` resample (``seed`` is the shard's), ``send`` / ``send_e``
    receive the rows' values, and ``part`` (2W,) int32 receives the
    shard's dense per-weight (gradient sum as float32 bits, count),
    zero for the weights it does not touch. CPU tensors run the plain
    version; CUDA tensors launch the step, reduce and partial kernels
    (errors raise). :func:`learn_apply` sums the shards' partials."""
    W = lt.w_fixed.numel()
    if x.device.type == "cpu":
        learn_color_partial_reference(lt, ci, x, xe, w, seed, epoch, hs,
                                      part, send, send_e, ext_p, ext_e)
        return
    if x.device.type != "cuda":
        raise ValueError("learn_color_partial: unsupported device %s"
                         % x.device)
    global LEARN_LAUNCHES
    _check("part", part, torch.int32, lt.sweep.device, (2 * W,))
    _launch_learn_rows(lt, ci, x, xe, w, seed, epoch, hs, send, send_e,
                       ext_p, ext_e)
    p = lt.ptrs
    has_wt = lt.sweep.n_rows[ci] > 0 and lt.n_wt[ci] > 0
    _raise_if(_kernel_lib("itemgrid_learn").nsx_learn_partial(
        p["wt_wid"], p["wt_ch0"], p["wt_nch"], p["chunk_g"], p["chunk_n"],
        _ptr(part), _ptr(part[W:]), lt.wt0[ci],
        lt.n_wt[ci] if has_wt else 0, W, _stream(part.device)),
        "learn partial kernel")
    LEARN_LAUNCHES += int(has_wt)


def learn_apply(payload: torch.Tensor, goff: int, w_fixed: torch.Tensor,
                w: torch.Tensor, seed: int, epoch: int, ci: int,
                hs: LearnStep) -> None:
    """Sum every shard's partial of step ``ci`` in shard order and apply
    the update to ``w`` (see :func:`learn_apply_reference`). CPU tensors
    run the plain version; CUDA tensors launch the apply kernel (errors
    raise)."""
    if w.device.type == "cpu":
        learn_apply_reference(payload, goff, w_fixed, w, seed, epoch, ci,
                              hs)
        return
    if w.device.type != "cuda":
        raise ValueError("learn_apply: unsupported device %s" % w.device)
    global LEARN_LAUNCHES
    W = w.numel()
    _check("payload", payload, torch.int32, w.device)
    _check("w_fixed", w_fixed, torch.int8, w.device, (W,))
    if payload.dim() != 2 or goff + 2 * W > payload.shape[1]:
        raise ValueError("payload %s holds no partial of %d weights at %d"
                         % (tuple(payload.shape), W, goff))
    if W == 0:
        return
    _raise_if(_kernel_lib("itemgrid_learn").nsx_learn_apply(
        _ptr(payload), _ptr(w_fixed), _ptr(w), payload.shape[0],
        payload.shape[1], goff, W, int(hs.mean), hs.regularization,
        hs.step, hs.shrink, hs.l1d, hs.thresh, seed,
        _coin_salt(epoch, ci), _stream(w.device)),
        "learn apply kernel")
    LEARN_LAUNCHES += 1


def learn_color(lt: LearnTables, ci: int, x: torch.Tensor,
                xe: torch.Tensor, w: torch.Tensor, seed: int, epoch: int,
                hs: LearnStep, ext_p: torch.Tensor | None = None,
                ext_e: torch.Tensor | None = None) -> None:
    """One (epoch, color) learn step, in place. CPU tensors run the
    plain version; CUDA tensors launch the kernels (errors raise).
    ``ext_p`` / ``ext_e`` (V, K') add external potentials to the free /
    clamped chain before the draws."""
    if x.device.type == "cpu":
        learn_color_step_reference(lt, ci, x, xe, w, seed, epoch, hs,
                                   ext_p, ext_e)
    elif x.device.type == "cuda":
        _launch_learn(lt, ci, x, xe, w, seed, epoch, hs, ext_p, ext_e)
    else:
        raise ValueError("learn_color: unsupported device %s" % x.device)


class ItemGridEngine:
    """Fused chromatic Gibbs inference and learning over a
    CompiledGraph.

    ``run`` sweeps burn-in plus tallied epochs and returns
    ``(values (V,), counts (V, K))`` in original variable order, as
    tensors on ``device``. There is no cap on the epoch count (tallies
    are int32). ``learn`` runs the dual-chain SGD and returns
    ``(weights, free chain, clamped chain)``. Both take external
    per-(variable, value) potentials (``ext_pot``, and ``ext_pot_evid``
    for learning's clamped chain): the incoming boundary messages of
    partitioned execution (``parallel/bsp``), which launch the kernels'
    has_ext forms."""

    def __init__(self, cg: CompiledGraph, sample_evidence: bool = True,
                 device="cuda", schedule: Schedule | None = None):
        device = torch.device(device)
        if cg.kmax > K_MAX_SUP:
            raise ValueError("cardinality %d > %d" % (cg.kmax, K_MAX_SUP))
        self.cg = cg
        self.device = device
        self.sample_evidence = bool(sample_evidence)
        self.schedule = schedule or default_schedule(cg)
        self.tables = build_tables(cg, self.schedule, sample_evidence,
                                   device)
        self._learn = None

    def _tensor(self, value, default, dtype):
        v = default if value is None else value
        return torch.as_tensor(v, dtype=dtype, device=self.device).clone()

    def _ext(self, ext):
        """An external potential table (V, K'), numpy or tensor, as a
        float32 tensor on the engine's device (not copied when it is
        one already), or None. K' may differ from kmax: columns beyond
        kmax are ignored and missing columns add nothing
        (itemgrid_pallas.py:3105-3107)."""
        if ext is None:
            return None
        e = torch.as_tensor(ext, dtype=torch.float32, device=self.device)
        if e.dim() != 2 or e.shape[0] != self.cg.n_vars or e.shape[1] < 1:
            raise ValueError("external potentials of shape %s, expected "
                             "(%d, K >= 1)" % (tuple(e.shape),
                                               self.cg.n_vars))
        return e.contiguous()

    def run(self, seed: int, burn: int, epochs: int, weight_value=None,
            x0=None, ext_pot=None, plain: bool = False):
        """``ext_pot`` (V, K'): external potentials added to every
        variable's conditional before each draw. ``plain=True`` runs the
        plain version on the engine's device (how ``chip_smoke.py``
        holds the kernel to it on the card)."""
        step = color_step_reference if plain else sweep_color
        cg, dev = self.cg, self.device
        w = self._tensor(weight_value, cg.weight_init, torch.float32)
        x = self._tensor(x0, cg.var_init, torch.int32)
        ext = self._ext(ext_pot)
        counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                             device=dev)
        s977 = seed977_of(seed)
        for epoch in range(burn + epochs):
            for ci in range(self.tables.n_steps):
                step(self.tables, ci, x, counts, w, s977, epoch,
                     epoch >= burn, ext=ext)
        return x, counts

    def learn_tables(self) -> LearnTables:
        if self._learn is None:
            self._learn = build_learn_tables(self.tables,
                                             self.cg.weight_fixed)
        return self._learn

    def learn(self, seed: int, burn: int, epochs: int, stepsize: float,
              decay: float = 1.0, lp: LearnParams | None = None,
              weight_value=None, x0=None, xe0=None, ext_pot=None,
              ext_pot_evid=None, plain: bool = False):
        """Dual-chain SGD (PallasItemGridEngine.learn): ``burn`` sweeps
        of the free chain, then ``epochs`` learning epochs; returns
        ``(w (W,), x (V,), xe (V,))`` tensors on the engine's device.
        The engine must be built with ``sample_evidence=True``, so that
        the free chain resamples evidence too. ``ext_pot`` (V, K') adds
        external potentials to the free chain (burn-in included) and
        ``ext_pot_evid`` to the clamped chain; without
        ``ext_pot_evid`` the clamped chain takes ``ext_pot``, as
        ``GibbsEngine`` does (numbskull_tpu/ops/gibbs.py:451-453).
        ``plain=True`` runs the plain versions on the engine's device."""
        if not self.sample_evidence:
            raise ValueError("learning needs an engine built with "
                             "sample_evidence=True")
        lp = lp or LearnParams()
        if lp.regularization not in (0, 1, 2) or \
                lp.grad_agg not in ("mean", "sum"):
            raise ValueError("unsupported learn parameters %s" % (lp,))
        cg = self.cg
        w = self._tensor(weight_value, cg.weight_init, torch.float32)
        x = self._tensor(x0, cg.var_init, torch.int32)
        xe = self._tensor(xe0, cg.var_init, torch.int32)
        ext_p = self._ext(ext_pot)
        ext_e = self._ext(ext_pot_evid)
        if ext_e is None:
            ext_e = ext_p
        elif ext_p is not None and ext_p.shape[1] != ext_e.shape[1]:
            raise ValueError("ext_pot and ext_pot_evid differ in width: "
                             "%d, %d" % (ext_p.shape[1], ext_e.shape[1]))
        lt = self.learn_tables()
        seed = _i32(seed)
        if burn > 0:
            counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                                 device=self.device)
            sweep = color_step_reference if plain else sweep_color
            for b in range(burn):
                for ci in range(lt.sweep.n_steps):
                    sweep(lt.sweep, ci, x, counts, w, seed, b, False,
                          BURN_SALT_XOR, ext=ext_p)
        learn_step = learn_color_step_reference if plain else learn_color
        for i in range(epochs):
            hs = learn_step_of(lp, stepsize, decay, i)
            for ci in range(lt.sweep.n_steps):
                learn_step(lt, ci, x, xe, w, seed, i + LEARN_EPOCH0, hs,
                           ext_p, ext_e)
        return w, x, xe
