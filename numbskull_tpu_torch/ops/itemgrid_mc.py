"""Graph-sharded itemgrid inference and learning: the item tables and
compute of one graph split over shards, with a per-color exchange.

Port of ``MultiChipItemGridEngine`` (numbskull_tpu/ops/itemgrid_pallas.py:
3176-3578) and of its exchange ``_exchange_color`` (:1545). Each shard
owns, in every step of the sweep, the rows whose draw position lies in
its share of the color's blocks (``itemgrid.shard_rows``, the split rule
of ``shard_schedule``) and holds only those rows' items and arguments
(``build_tables(..., shard=(d, n_g))``); every shard keeps a whole
replica of the chains. Per (epoch, color):

1. each shard resamples its rows with the sweep kernel
   (``csrc/itemgrid_sweep.cu``, its own seed ``int32(seed*977 + d)`` and
   salt ``int32(int32((epoch*(COLOR_MAX+1) + ci)*n_g + d)*65536)``, the
   block index local to the shard) and packs the new values into its
   send buffer through the kernel's ``send`` pointer;
2. the buffers move to every other shard, and ``unpack``
   (``csrc/itemgrid_exchange.cu``) scatters them into each replica at
   the senders' rows;
3. in learning (``csrc/itemgrid_learn.cu``), each shard's step kernel
   and the sum kernel's dense epilogue leave its per-weight (gradient
   sum, count)
   in the buffer beside both chains' rows, and after the transfer the
   apply kernel adds the shards' partials in shard order 0..n_g-1 from
   0.0 and updates the weights, the same update on every shard.

Two exchange modes, chosen by the caller:

- ``n_shards=N`` without a group: N shards, each with its own replica of
  the chains, in this process on ``device``. The shards write straight
  into one payload tensor, so the transfer is free and the exchange is
  the unpack into the other replicas.
- ``group=`` a ``torch.distributed`` process group: this process is
  shard ``rank`` of ``size``, with one replica. The buffers move by
  ``all_gather``: device buffers under ``nccl``; under any other backend
  (``gloo``) the buffer is copied to host memory, gathered there, and
  copied back to the device, one round trip per (epoch, color).

Each shard tallies its own rows in the sweep kernel. In one process the
shards share one count tensor (their rows are disjoint); across
processes ``run`` sums the counts over the group once, at the end, in
int32, which is exact.

``run_emulated`` is the counterpart of the TPU engine's sequential
emulation (kernel #5, ``_make_kernel(one_color=True)``): one sweep
launch per (epoch, color, shard) on one shared value array, no exchange.
Within a color no row reads a row of its own color, so it equals ``run``
bit for bit. A step whose color is not independent (``--max_colors``)
reads, within each shard, a snapshot taken before the launch; across
shards ``run`` reads every other shard's rows from before the step (they
arrive by the exchange after it), while ``run_emulated`` reads the rows
of the shards before it after their update, so there the two differ, as
on the TPU.

Deviations from the TPU engine: L1 learning runs at any shard count (the
counter hash is shared by every shard, so the coin from the base seed is
the same everywhere; the TPU engine refuses L1 on hardware PRNGs with
more than one device), no 30000-epoch cap (int32 tallies), and tallies
summed over shards once instead of tallied on every device's replica.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from numbskull_tpu_torch.compile import CompiledGraph
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams

#: launches of the CUDA unpack kernel in this process; the wrapper adds
#: one where it launches and nowhere else
EXCHANGE_LAUNCHES = 0


@dataclasses.dataclass
class StepRows:
    """The rows of one step of every shard, on the engine's device: the
    variables of shard d are ``vid[offs[d]:offs[d+1]]``, in the order of
    that shard's table rows; ``rs`` is the most rows one shard has."""

    vid: torch.Tensor      # (n_rows,) int32
    offs: torch.Tensor     # (n_g + 1,) int32
    offs_host: list
    rs: int


def step_rows(cg: CompiledGraph, schedule: pig.Schedule, n_g: int,
              device) -> list:
    """Every step's :class:`StepRows` (the same split as the shards'
    tables; each shard needs every other shard's rows to unpack them)."""
    upos = np.asarray(schedule.upos, np.int64)
    out = []
    for c in schedule.colors:
        p = cg.plans[c]
        vids = p.cv_vid[p.cv_valid].astype(np.int64)
        parts = [vids[pig.shard_rows(upos[vids], n_g, d)[0]]
                 for d in range(n_g)]
        offs = np.concatenate(([0], np.cumsum([len(q) for q in parts])))
        out.append(StepRows(
            vid=torch.as_tensor(np.concatenate(parts).astype(np.int32),
                                device=device),
            offs=torch.as_tensor(offs.astype(np.int32), device=device),
            offs_host=[int(o) for o in offs],
            rs=max(len(q) for q in parts)))
    return out


def unpack_reference(rows: StepRows, payload: torch.Tensor,
                     x: torch.Tensor, xe: torch.Tensor | None = None,
                     skip: int = -1) -> None:
    """Plain version of the unpack kernel: for every shard d but
    ``skip``, ``x[vid_d] = payload[d, :n_d]`` and, given ``xe``,
    ``xe[vid_d] = payload[d, rs:rs + n_d]``."""
    o = rows.offs_host
    for d in range(len(o) - 1):
        n = o[d + 1] - o[d]
        if d == skip or n == 0:
            continue
        vid = rows.vid[o[d]:o[d + 1]].to(torch.int64)
        x[vid] = payload[d, :n]
        if xe is not None:
            xe[vid] = payload[d, rows.rs:rows.rs + n]


def unpack(rows: StepRows, payload: torch.Tensor, x: torch.Tensor,
           xe: torch.Tensor | None = None, skip: int = -1) -> None:
    """Scatter every other shard's packed rows of one step into this
    replica (``payload`` (n_g, stride) int32; shard ``skip``'s rows are
    this replica's own). CPU tensors run the plain version; CUDA tensors
    launch the kernel (errors raise). Nothing to receive launches
    nothing and counts nothing."""
    global EXCHANGE_LAUNCHES
    if x.device.type == "cpu":
        unpack_reference(rows, payload, x, xe, skip)
        return
    if x.device.type != "cuda":
        raise ValueError("unpack: unsupported device %s" % x.device)
    o = rows.offs_host
    n_g = len(o) - 1
    width = 2 * rows.rs if xe is not None else rows.rs
    if payload.dim() != 2 or payload.shape[0] != n_g or \
            payload.shape[1] < width:
        raise ValueError("payload %s does not hold %d shards of %d values"
                         % (tuple(payload.shape), n_g, width))
    for name, a in (("x", x), ("xe", xe), ("payload", payload),
                    ("vid", rows.vid), ("offs", rows.offs)):
        if a is not None:
            pig._check(name, a, torch.int32, x.device)
    if xe is not None and xe.shape != x.shape:
        raise ValueError("xe has shape %s, x %s" % (tuple(xe.shape),
                                                    tuple(x.shape)))
    lo, hi = (o[skip], o[skip + 1]) if 0 <= skip < n_g else (0, 0)
    if o[-1] - (hi - lo) == 0:
        return
    fn = pig._kernel_lib("itemgrid_exchange").nsx_exchange_unpack
    pig._raise_if(fn(pig._ptr(rows.vid), pig._ptr(rows.offs),
                     pig._ptr(payload), pig._ptr(x),
                     pig._ptr(xe) if xe is not None else None, o[-1], n_g,
                     payload.shape[1], rows.rs, lo, hi,
                     pig._stream(x.device)), "exchange unpack kernel")
    EXCHANGE_LAUNCHES += 1


# the functions each engine loop calls: the wrappers, or (``plain=True``)
# the plain versions on whatever device the tensors are
_KERNELS = dict(sweep=pig.sweep_color, partial=pig.learn_color_partial,
                apply=pig.learn_apply, unpack=unpack)
_PLAIN = dict(sweep=pig.color_step_reference,
              partial=pig.learn_color_partial_reference,
              apply=pig.learn_apply_reference, unpack=unpack_reference)


class MultiChipItemGridEngine:
    """Graph-sharded itemgrid inference and learning over ``n_shards``
    shards in this process, or over the processes of ``group`` (one
    shard each); see the module docstring.

    ``run`` and ``run_emulated`` return ``(values (V,), counts (V, K))``
    in original variable order, ``learn`` returns ``(w, x, xe)``, all
    tensors on ``device``. ``plain=True`` runs the plain versions of
    every kernel on ``device`` instead, to hold the kernels against
    them."""

    def __init__(self, cg: CompiledGraph, n_shards: int | None = None,
                 group=None, sample_evidence: bool = True, device="cuda",
                 schedule: pig.Schedule | None = None):
        if cg.kmax > pig.K_MAX_SUP:
            raise ValueError("cardinality %d > %d" % (cg.kmax,
                                                       pig.K_MAX_SUP))
        self.group = group
        if group is not None:
            n_g = dist.get_world_size(group)
            if n_shards is not None and int(n_shards) != n_g:
                raise ValueError("n_shards %d != the group's %d processes"
                                 % (n_shards, n_g))
            self.shards = (dist.get_rank(group),)
            self.backend = dist.get_backend(group)
        else:
            n_g = 1 if n_shards is None else int(n_shards)
            if n_g < 1:
                raise ValueError("n_shards must be >= 1, got %d" % n_g)
            self.shards = tuple(range(n_g))
            self.backend = None
        self.n_g = n_g
        self.cg = cg
        self.device = torch.device(device)
        self.sample_evidence = bool(sample_evidence)
        self.schedule = schedule or pig.default_schedule(cg)
        self.tables = [pig.build_tables(cg, self.schedule, sample_evidence,
                                        self.device, shard=(d, n_g))
                       for d in self.shards]
        self.rows = step_rows(cg, self.schedule, n_g, self.device)
        self._learn = None

    @property
    def n_steps(self) -> int:
        return len(self.rows)

    def _tensor(self, value, default, dtype):
        v = default if value is None else value
        return torch.as_tensor(v, dtype=dtype, device=self.device).clone()

    def _buffers(self, width: int):
        """Room for the exchange of steps of at most ``width`` values per
        shard: (the payload (n_g * width,) int32, this process's own send
        buffer, or None where the shards write into the payload)."""
        pay = torch.empty(self.n_g * width, dtype=torch.int32,
                          device=self.device)
        if self.group is None or self.n_g == 1:
            return pay, None
        return pay, torch.empty(width, dtype=torch.int32,
                                device=self.device)

    def _step_buffers(self, bufs, width: int):
        """One step's payload (n_g, width) and the send buffer of every
        shard run here. In one process, or in a group of one, a shard's
        send buffer is its row of the payload."""
        pay = bufs[0][:self.n_g * width].view(self.n_g, width)
        if bufs[1] is None:
            return pay, [pay[d] for d in self.shards]
        return pay, [bufs[1][:width]]

    def _gather(self, send: torch.Tensor, pay: torch.Tensor) -> None:
        """all_gather of every process's ``send`` into ``pay`` (n_g, P)."""
        if self.backend == "nccl":
            dist.all_gather_into_tensor(pay.view(-1), send,
                                        group=self.group)
            return
        # gloo and other host backends: through host memory
        host = pay if pay.device.type == "cpu" else \
            torch.empty(pay.shape, dtype=pay.dtype)
        dist.all_gather(list(host.unbind(0)), send.cpu(), group=self.group)
        if host is not pay:
            pay.copy_(host)

    def _exchange(self, fns, ci: int, pay: torch.Tensor, sends, xs,
                  xes=None) -> None:
        """Step ``ci``'s transfer and unpack into every replica here."""
        if self.n_g == 1:
            return
        if self.group is not None:
            self._gather(sends[0], pay)
        for j, d in enumerate(self.shards):
            fns["unpack"](self.rows[ci], pay, xs[j],
                          None if xes is None else xes[j], d)

    def _replicas(self, value, default):
        x = self._tensor(value, default, torch.int32)
        return x.repeat(len(self.shards), 1)

    def run(self, seed: int, burn: int, epochs: int, weight_value=None,
            x0=None, plain: bool = False):
        """``burn`` + ``epochs`` sharded sweeps; tallies after burn-in."""
        fns = _PLAIN if plain else _KERNELS
        cg, n_g = self.cg, self.n_g
        w = self._tensor(weight_value, cg.weight_init, torch.float32)
        xs = self._replicas(x0, cg.var_init)
        counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                             device=self.device)
        bufs = self._buffers(max(r.rs for r in self.rows)
                             if self.rows else 0)
        for epoch in range(burn + epochs):
            for ci, rows in enumerate(self.rows):
                pay, sends = self._step_buffers(bufs, rows.rs)
                for j, d in enumerate(self.shards):
                    fns["sweep"](self.tables[j], ci, xs[j], counts, w,
                                 pig.mc_seed977_of(seed, d), epoch,
                                 epoch >= burn, 0,
                                 pig.mc_salt16_of(epoch, ci, n_g, d),
                                 sends[j])
                self._exchange(fns, ci, pay, sends, xs)
        if self.group is not None:
            self._sum_counts(counts)
        return xs[0], counts

    def _sum_counts(self, counts: torch.Tensor) -> None:
        if self.backend == "nccl":
            dist.all_reduce(counts, group=self.group)
            return
        host = counts.cpu()
        dist.all_reduce(host, group=self.group)
        if host is not counts:
            counts.copy_(host)

    def run_emulated(self, seed: int, burn: int, epochs: int,
                     weight_value=None, x0=None, plain: bool = False):
        """The sequential emulation: per (epoch, color, shard) one sweep
        launch on one shared value array, no exchange (every shard runs
        in this process)."""
        if self.group is not None:
            raise ValueError("run_emulated runs every shard in one process;"
                             " build the engine with n_shards, not group")
        fns = _PLAIN if plain else _KERNELS
        cg, n_g = self.cg, self.n_g
        w = self._tensor(weight_value, cg.weight_init, torch.float32)
        x = self._tensor(x0, cg.var_init, torch.int32)
        counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                             device=self.device)
        for epoch in range(burn + epochs):
            for ci in range(self.n_steps):
                for d in range(n_g):
                    fns["sweep"](self.tables[d], ci, x, counts, w,
                                 pig.mc_seed977_of(seed, d), epoch,
                                 epoch >= burn, 0,
                                 pig.mc_salt16_of(epoch, ci, n_g, d))
        return x, counts

    def learn_tables(self) -> list:
        """Every shard's learn tables (its own items only), built on
        first use."""
        if self._learn is None:
            self._learn = [pig.build_learn_tables(t, self.cg.weight_fixed)
                           for t in self.tables]
        return self._learn

    def learn(self, seed: int, burn: int, epochs: int, stepsize: float,
              decay: float = 1.0, lp: LearnParams | None = None,
              weight_value=None, x0=None, xe0=None, plain: bool = False):
        """Graph-sharded dual-chain SGD (MultiChipItemGridEngine.learn):
        ``burn`` sweeps of the free chain, then ``epochs`` learning
        epochs, both chains exchanged after every color and the
        weights updated from the shards' partials summed in shard
        order. Returns ``(w (W,), x (V,), xe (V,))``."""
        if not self.sample_evidence:
            raise ValueError("learning needs an engine built with "
                             "sample_evidence=True")
        lp = lp or LearnParams()
        if lp.regularization not in (0, 1, 2) or \
                lp.grad_agg not in ("mean", "sum"):
            raise ValueError("unsupported learn parameters %s" % (lp,))
        fns = _PLAIN if plain else _KERNELS
        cg = self.cg
        W = int(cg.n_weights)
        w = self._tensor(weight_value, cg.weight_init, torch.float32)
        xs = self._replicas(x0, cg.var_init)
        xes = self._replicas(xe0, cg.var_init)
        lts = self.learn_tables()
        seed = pig._i32(seed)
        seeds = [pig.mc_learn_seed_of(seed, d) for d in self.shards]
        rs_max = max(r.rs for r in self.rows) if self.rows else 0
        bufs = self._buffers(2 * rs_max + 2 * W)
        if burn > 0:
            counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                                 device=self.device)
            for b in range(burn):
                for ci, rows in enumerate(self.rows):
                    pay, sends = self._step_buffers(bufs, rows.rs)
                    for j in range(len(self.shards)):
                        fns["sweep"](lts[j].sweep, ci, xs[j], counts, w,
                                     seeds[j], b, False, pig.BURN_SALT_XOR,
                                     None, sends[j])
                    self._exchange(fns, ci, pay, sends, xs)
        for i in range(epochs):
            hs = pig.learn_step_of(lp, stepsize, decay, i)
            epoch = i + pig.LEARN_EPOCH0
            for ci, rows in enumerate(self.rows):
                rs = rows.rs
                pay, sends = self._step_buffers(bufs, 2 * rs + 2 * W)
                for j in range(len(self.shards)):
                    s = sends[j]
                    fns["partial"](lts[j], ci, xs[j], xes[j], w, seeds[j],
                                   epoch, hs, s[2 * rs:], s[:rs],
                                   s[rs:2 * rs])
                self._exchange(fns, ci, pay, sends, xs, xes)
                fns["apply"](pay, 2 * rs, lts[0].w_fixed, w, seed, epoch,
                             ci, hs)
        return w, xs[0], xes[0]

    def marginals(self, counts: torch.Tensor, epochs: int) -> torch.Tensor:
        return counts.to(torch.float64) / float(max(epochs, 1))
