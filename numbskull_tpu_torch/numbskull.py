"""Public API and CLI of the PyTorch port: ``NumbSkull`` and
``python -m numbskull_tpu_torch``.

Port of ``numbskull_tpu/numbskull.py``: the same argument table and the
same two output files (reference: numbskull/numbskull.py:18-149 argument
tables, :359-391 output files), with learning (``-l N``) running through
the learn kernels and inference through the fused sweep kernel of
``ops/itemgrid``, on the device named by ``--device``. A graph outside
the kernels' envelope (``ops/itemgrid.EnvelopeError``) runs on the
tensor-op ``ops/gibbs.GibbsEngine`` on the same device instead, as the
JAX CLI falls back to its XLA engine; ``--engine xla`` runs that engine
for every graph. Learning runs first; inference continues from the
learned weights and the learned free chain. ``--checkpoint`` runs both
in resumable chunks (``checkpoint.py``), ``-u`` reads the graph from a
database (``dbsource.py``), and ``--parts N`` runs the whole job
partitioned (:func:`run_distributed`, ``parallel/bsp.BSPEngine``).
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

import numpy as np
import torch

from numbskull_tpu_torch import dataloading
from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.observability import annotate, metrics
from numbskull_tpu_torch.ops.gibbs import GibbsEngine, LearnParams, init_state
from numbskull_tpu_torch.ops.itemgrid import EnvelopeError, ItemGridEngine
from numbskull_tpu_torch.timer import Timer

# Declarative argument tables shared by the CLI and the class: those of
# numbskull_tpu/numbskull.py (reference numbskull/numbskull.py:18-126,
# same dests and defaults) plus --device.
arguments = [
    (("directory",),
        {"metavar": "DIRECTORY", "nargs": "?", "default": ".", "type": str,
         "help": "specify the directory of factor graph files"}),
    (("-o", "--output_dir"),
        {"metavar": "OUTPUT_DIR", "dest": "output_dir", "default": ".",
         "type": str,
         "help": "output dir for inference_result.out.text and "
                 "inference_result.out.weights.text"}),
    (("-m", "--meta", "--fg_meta"),
        {"metavar": "META_FILE", "dest": "metafile", "default": "graph.meta",
         "type": str, "help": "factor graph metadata file"}),
    (("-w", "--weight", "--weights"),
        {"metavar": "WEIGHTS_FILE", "dest": "weightfile",
         "default": "graph.weights", "type": str,
         "help": "factor weight file"}),
    (("-v", "--variable", "--variables"),
        {"metavar": "VARIABLES_FILE", "dest": "variablefile",
         "default": "graph.variables", "type": str,
         "help": "factor graph variables file"}),
    (("-f", "--factor", "--factors"),
        {"metavar": "FACTORS_FILE", "dest": "factorfile",
         "default": "graph.factors", "type": str, "help": "factor file"}),
    (("--domain", "--domains"),
        {"metavar": "DOMAINS_FILE", "dest": "domainfile",
         "default": "graph.domains", "type": str, "help": "domain file"}),
    (("-l", "--n_learning_epoch"),
        {"metavar": "NUM_LEARNING_EPOCHS", "dest": "n_learning_epoch",
         "default": 0, "type": int, "help": "number of learning epochs"}),
    (("-i", "--n_inference_epoch"),
        {"metavar": "NUM_INFERENCE_EPOCHS", "dest": "n_inference_epoch",
         "default": 0, "type": int, "help": "number of inference epochs"}),
    (("-s", "--stepsize", "-a", "--alpha"),
        {"metavar": "LEARNING_STEPSIZE", "dest": "stepsize",
         "default": 0.01, "type": float, "help": "stepsize for learning"}),
    (("-d", "--decay", "--diminish"),
        {"metavar": "LEARNING_DECAY", "dest": "decay", "default": 0.95,
         "type": float, "help": "stepsize decay per learning epoch"}),
    (("-r", "--reg_param"),
        {"metavar": "LEARNING_REGULARIZATION_PARAM", "dest": "reg_param",
         "default": 0.01, "type": float, "help": "regularization penalty"}),
    (("--regularization",),
        {"metavar": "REGULARIZATION", "dest": "regularization", "default": 2,
         "type": int, "help": "regularization (1 = L1, 2 = L2)"}),
    (("-k", "--truncation"),
        {"metavar": "TRUNCATION", "dest": "truncation", "default": 1,
         "type": int,
         "help": "L1 truncated-gradient: truncate with probability 1/k and "
                 "magnitude step_size * reg_param * k"}),
    (("-b", "--burn_in"),
        {"metavar": "BURN_IN", "dest": "burn_in", "default": 0, "type": int,
         "help": "number of burn-in epochs"}),
    (("-t", "--threads", "--n_threads"),
        {"metavar": "NUM_THREADS", "dest": "nthreads", "default": 1,
         "type": int,
         "help": "accepted for reference compatibility; the engine "
                 "parallelizes per color, not per thread"}),
    (("-u", "--dburl"),
        {"metavar": "DATABASE_URL", "dest": "dburl", "default": "",
         "type": str, "help": "database URL (distributed graph source)"}),
    (("--seed",),
        {"metavar": "SEED", "dest": "seed", "default": 0, "type": int,
         "help": "seed of the counter-hash draw streams (fully "
                 "reproducible)"}),
    (("--grad_agg",),
        {"metavar": "GRAD_AGG", "dest": "grad_agg", "default": "mean",
         "type": str, "choices": ("mean", "sum"),
         "help": "per-color gradient aggregation: 'mean' (stable "
                 "mini-batch SGD, default) or 'sum' (reproduces the "
                 "reference's aggregate per-epoch weight movement, "
                 "learning.py:111-125)"}),
    (("--engine",),
        {"metavar": "ENGINE", "dest": "engine", "default": "auto",
         "type": str, "choices": ("auto", "xla", "itemgrid", "hbm"),
         "help": "compute engine: 'auto', 'itemgrid' and 'hbm' run the "
                 "fused sweep and learn kernels, which keep every graph "
                 "in device memory (the TPU package's 'hbm' engine for "
                 "graphs beyond its VMEM cap is the same kernels here), "
                 "and fall back to the tensor-op engine for graphs the "
                 "kernels refuse (a warning names the reason under "
                 "'itemgrid' and 'hbm'); 'xla' runs the tensor-op engine "
                 "(ops/gibbs.GibbsEngine) for every graph"}),
    (("--checkpoint",),
        {"metavar": "CHECKPOINT_FILE", "dest": "checkpoint", "default": "",
         "type": str,
         "help": "checkpoint inference to FILE (and learning to "
                 "FILE.learn: weights, both chains, stepsize schedule) "
                 "every --checkpoint_every epochs and resume from it if "
                 "it exists; composes with engine dispatch (kernels or "
                 "tensor-op engine per chunk). Resume is bit-exact when "
                 "the same engine is selected (under --engine xla "
                 "chunked runs equal uninterrupted ones exactly)"}),
    (("--checkpoint_every",),
        {"metavar": "N", "dest": "checkpoint_every", "default": 100,
         "type": int, "help": "epochs between checkpoints"}),
    (("--metrics_out",),
        {"metavar": "METRICS_JSON", "dest": "metrics_out", "default": "",
         "type": str,
         "help": "write a JSON metrics snapshot (epochs, wall times, "
                 "update counts) after the run"}),
    (("--plan_cache",),
        {"metavar": "DIR", "dest": "plan_cache", "default": "",
         "type": str,
         "help": "disk plan cache directory (default: NSX_PLAN_CACHE "
                 "env var): byte-identical graphs reload their compiled "
                 "color plans instead of recompiling (see plancache)"}),
    (("--max_colors",),
        {"metavar": "MAX_COLORS", "dest": "max_colors", "default": None,
         "type": int,
         "help": "cap chromatic colors; overflow vars share the last color "
                 "(hogwild-style races, like the reference's threads)"}),
    (("--parts",),
        {"metavar": "N", "dest": "parts", "default": 0, "type": int,
         "help": "run the whole job PARTITIONED into N parts: choose a "
                 "partition (DB partition keys compete against the "
                 "cost-model menu), distributed learning with per-epoch "
                 "weight-delta reduction, distributed inference, same "
                 "output files — the reference's one-command cluster "
                 "flow (salt/src/numbskull_master.py:547-584)"}),
    (("--device",),
        {"metavar": "DEVICE", "dest": "device", "default": "cuda",
         "type": str, "choices": ("cuda", "cpu"),
         "help": "device of the sampler state: 'cuda' runs the CUDA sweep "
                 "kernel on the GPU (and raises when none is visible); "
                 "'cpu' runs its plain PyTorch version"}),
    (("--dist_mode",),
        {"metavar": "MODE", "dest": "dist_mode", "default": "auto",
         "type": str, "choices": ("auto", "values", "messages"),
         "help": "boundary exchange for --parts: ghost values or "
                 "per-value potential messages (the PF/UFO "
                 "generalization); auto picks messages when every "
                 "straddling factor is UFO-eligible"}),
]

flags = [
    (("--sample_evidence",),
        {"default": True, "dest": "sample_evidence", "action": "store_true",
         "help": "sample evidence variables during inference"}),
    (("--learn_non_evidence",),
        {"default": False, "dest": "learn_non_evidence",
         "action": "store_true",
         "help": "compute gradients from non-evidence variables"}),
    (("-q", "--quiet"),
        {"default": False, "dest": "quiet", "action": "store_true",
         "help": "quiet"}),
    (("--verbose",),
        {"default": False, "dest": "verbose", "action": "store_true",
         "help": "verbose"}),
]


def _native_dump(path: str, a, b, x, dec: int) -> bool:
    """Write `a [b] x` text rows via the native core (compilecore.so
    dump_rows); returns False when unavailable (numpy fallback runs)."""
    from numbskull_tpu_torch.compile import _compilecore, _ptr
    core = _compilecore()
    if core is None:
        return False
    import ctypes
    a = np.ascontiguousarray(a, np.int64)
    bp = None
    if b is not None:
        b = np.ascontiguousarray(b, np.int64)
        bp = _ptr(b)
    x = np.ascontiguousarray(x, np.float64)
    rc = core.dump_rows(path.encode(), ctypes.c_int64(len(a)), _ptr(a),
                        bp, _ptr(x), ctypes.c_int(dec))
    return rc == 0


def _digit_block(a: np.ndarray, width: int, pad_zero: bool,
                 neg: np.ndarray | None) -> np.ndarray:
    """(N, width) uint8 right-aligned decimal digits of non-negative
    ``a``; leading positions are spaces (or zeros when ``pad_zero``),
    with '-' placed just left of the first digit for ``neg`` rows.

    Pure digit arithmetic — every numpy text conversion (astype('S'),
    np.char, savetxt) is a per-element sprintf and takes minutes at
    9.4M rows; this is a handful of vectorized integer passes."""
    n = len(a)
    out = np.empty((n, width), np.uint8)
    dt = np.int32 if (n == 0 or int(a.max()) < 2 ** 31) else np.int64
    cur = np.asarray(a).astype(dt, copy=True)
    live = np.ones(n, bool)            # rows with digits remaining
    prev = live
    for k in range(width):             # k-th digit from the right
        col = width - 1 - k
        digit = (cur % 10 + 48).astype(np.uint8)
        if pad_zero or k == 0:
            out[:, col] = digit
        else:
            # '-' lands one column left of a row's last digit
            fill = np.uint8(32) if neg is None else \
                np.where(prev & ~live & neg, np.uint8(45), np.uint8(32))
            out[:, col] = np.where(live, digit, fill)
        np.floor_divide(cur, 10, out=cur)
        prev = live
        live = live & (cur > 0)
    return out


def _int_width(a: np.ndarray) -> int:
    m = int(a.max()) if len(a) else 0
    return max(len(str(max(m, 1))), 1)


def _format_cols(cols) -> bytes:
    """`vid value prob`-style rows as one bytes blob: space-separated,
    right-aligned columns, newline-terminated. Each col is an int array
    or a ('fixed', array, decimals) fixed-point spec."""
    blocks = []
    n = None
    for c in cols:
        if isinstance(c, tuple):
            _, x, dec = c
            scale = 10 ** dec
            pm = np.round(np.asarray(x, np.float64) * scale).astype(
                np.int64)
            neg = pm < 0
            ap = np.abs(pm)
            ip, fr = ap // scale, ap % scale
            w = _int_width(ip) + (1 if neg.any() else 0)
            blocks.append(_digit_block(ip, w, False, neg))
            blocks.append(np.full((len(ip), 1), 46, np.uint8))   # '.'
            blocks.append(_digit_block(fr, dec, True, None))
        else:
            x = np.asarray(c, np.int64)
            neg = x < 0
            w = _int_width(np.abs(x)) + (1 if neg.any() else 0)
            blocks.append(_digit_block(np.abs(x), w, False, neg))
        n = len(x)
        blocks.append(np.full((n, 1), 32, np.uint8))             # ' '
    if n is None or n == 0:
        return b""
    blocks[-1][:] = 10                                           # '\n'
    return np.hstack(blocks).tobytes()


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; 'cuda' without a visible GPU
    raises (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "visible; pass --device cpu to run the plain "
                           "PyTorch version on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s" % device)
    return device


#: --engine values: 'xla' runs GibbsEngine, the others the fused kernels
ENGINES = ("auto", "xla", "itemgrid", "hbm")


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError("unknown engine %r" % (engine,))


def chunk_seed(seed: int, epoch_offset: int) -> int:
    """The kernels' seed of a run that starts at absolute epoch
    ``epoch_offset`` of a run with base seed ``seed``:
    ``SeedSequence([seed, epoch_offset])`` masked to 31 bits (the
    counterpart of ``jax.random.fold_in(key, epoch_offset)``,
    numbskull_tpu/numbskull.py:391-393, :481-483)."""
    ss = np.random.SeedSequence([int(seed), int(epoch_offset)])
    return int(ss.generate_state(1, np.uint32)[0] & 0x7FFFFFFF)


class FactorGraph:
    """One loaded factor graph: compiled plans, sampler state on one
    device, and the inference engine (built on first use).

    Role-equivalent of the reference FactorGraph
    (numbskull/factorgraph.py:27-229). ``engine`` is the JAX package's
    argument: 'auto', 'itemgrid' and 'hbm' all run ItemGridEngine (the
    port's kernels hold any graph in device memory), or GibbsEngine for
    a graph outside the kernels' envelope; 'xla' runs GibbsEngine for
    every graph (:meth:`engine`). Each graph adds one to the metrics
    counter ``engine.requested.<engine>``.

    Every run takes one base seed from :meth:`_next_seed` (or, resuming,
    from its checkpoint). A run in one call hands it to the engine; a
    checkpointed run's chunk starting at absolute epoch e hands
    GibbsEngine the base seed and ``epoch_offset`` e, and the kernels
    :func:`chunk_seed` of (base, e). A checkpointed run in chunks
    therefore equals the same run interrupted and resumed, bit for bit,
    on either engine, and under 'xla' it equals the run in one call."""

    def __init__(self, cg, fid: int, seed: int = 0, device="cuda",
                 engine: str = "auto"):
        _check_engine(engine)
        metrics.add("engine.requested." + engine)
        self.cg = cg
        self.fid = fid
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.engine_mode = engine
        self.state = init_state(cg, self.device)
        self.inference_epochs_done = 0
        self.inference_total_time = 0.0
        self.learning_total_time = 0.0
        self._last_learn_s = 0.0
        self._calls = 0
        self._engines = {}       # sample_evidence flag -> engine
        self._gibbs = None       # the GibbsEngine, once one is needed

    def _next_seed(self) -> int:
        """Base seed of the next run: SeedSequence([seed, fid, call])."""
        ss = np.random.SeedSequence([self.seed, self.fid, self._calls])
        self._calls += 1
        return int(ss.generate_state(1, np.uint32)[0] & 0x7FFFFFFF)

    def _gibbs_engine(self) -> GibbsEngine:
        if self._gibbs is None:
            self._gibbs = GibbsEngine(self.cg, device=self.device)
        return self._gibbs

    def engine(self, sample_evidence: bool):
        """The ItemGridEngine for ``sample_evidence``; under engine 'xla',
        and for a graph outside the kernels' envelope (EnvelopeError, and
        nothing else), the tensor-op GibbsEngine on the same device. Each
        refusal adds one to the metrics counter ``engine.fallbacks`` and,
        under engine 'itemgrid' or 'hbm', warns with the reason
        (numbskull_tpu/numbskull.py:283-328)."""
        key = bool(sample_evidence)
        if key not in self._engines:
            if self.engine_mode == "xla":
                self._engines[key] = self._gibbs_engine()
                return self._engines[key]
            try:
                self._engines[key] = ItemGridEngine(
                    self.cg, sample_evidence=key, device=self.device)
            except EnvelopeError as err:
                if self.engine_mode in ("itemgrid", "hbm"):
                    warnings.warn(
                        "--engine %s unavailable for this graph, falling "
                        "back to the tensor-op engine (ops/gibbs."
                        "GibbsEngine): %s" % (self.engine_mode, err))
                metrics.add("engine.fallbacks")
                self._engines[key] = self._gibbs_engine()
        return self._engines[key]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sweep(self, eng, burnin_epochs: int, epochs: int,
               sample_evidence: bool, seed: int, epoch_offset=None):
        """``burnin_epochs`` untallied and ``epochs`` tallied sweeps of
        the free chain on ``eng``, the tallies added to the state's;
        ``epoch_offset`` is a checkpointed chunk's first epoch (None for
        a run in one call)."""
        if isinstance(eng, GibbsEngine):
            self.state = eng.inference(
                self.state, seed, epochs, burn=burnin_epochs,
                sample_evidence=sample_evidence,
                epoch_offset=epoch_offset or 0)
        else:
            vals, counts = eng.run(
                seed if epoch_offset is None else
                chunk_seed(seed, epoch_offset), burnin_epochs, epochs,
                weight_value=self.state.weight_value,
                x0=self.state.var_value)
            self.state.var_value = vals
            self.state.count += counts

    def burnIn(self, epochs: int, sample_evidence: bool):
        """``epochs`` burn-in sweeps of the free chain, no tally
        (numbskull_tpu/numbskull.py:330-333)."""
        self._sweep(self.engine(sample_evidence), epochs, 0,
                    sample_evidence, self._next_seed())
        self._sync()

    def _chunked(self, path: str, every: int, epochs: int, done_key: str,
                 resume_metric: str, run) -> None:
        """``epochs`` epochs in chunks of ``every`` (at least 1), each as
        ``run(n, done, seed)``, the state and the base seed saved to
        ``path`` after each (meta ``done_key``: epochs done). An existing
        ``path`` is resumed, its seed with it (numbskull_tpu/numbskull.py:
        351-372, :440-461); otherwise the base seed is drawn, and only
        when there are epochs to run, as a run without a checkpoint does.
        Each chunk is an ``nsx.chunk`` region in a profiler trace."""
        from numbskull_tpu_torch.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
        every = max(int(every), 1)
        done, seed = 0, None
        if os.path.exists(path):
            self.state, seed, meta = load_checkpoint(path, self.device)
            done = int(meta.get(done_key, 0))
            metrics.add(resume_metric)
        if seed is None and done < epochs:
            seed = self._next_seed()
        while done < epochs:
            n = min(every, epochs - done)
            with annotate("nsx.chunk"):
                run(n, done, seed)
            done += n
            save_checkpoint(path, self.state, seed, meta={done_key: done})

    def inference(self, burnin_epochs: int, epochs: int,
                  sample_evidence: bool = False, diagnostics: bool = False,
                  checkpoint: str = "", checkpoint_every: int = 100):
        """Burn-in and ``epochs`` tallied epochs. With ``checkpoint``, the
        run goes in chunks of ``checkpoint_every`` epochs (at least 1),
        burn-in in the first only, the state and the base seed saved
        after each (meta ``epochs_done``); an existing file is resumed
        (numbskull_tpu/numbskull.py:339-378)."""
        if checkpoint:
            self._chunked(checkpoint, checkpoint_every, epochs,
                          "epochs_done", "inference.resumes",
                          lambda n, done, seed: self._infer_once(
                              burnin_epochs if done == 0 else 0, n,
                              sample_evidence, seed, done))
            if diagnostics:
                self.diagnostics(self.inference_epochs_done)
            return
        self._infer_once(burnin_epochs, epochs, sample_evidence,
                         self._next_seed())
        if diagnostics:
            print("FACTOR %d: inference %d epochs took %.3f sec" %
                  (self.fid, epochs, self._last_infer_s))
            self.diagnostics(self.inference_epochs_done)

    def _infer_once(self, burnin_epochs: int, epochs: int,
                    sample_evidence: bool, seed: int, epoch_offset=None):
        """One timed inference run (:meth:`_sweep`)."""
        with Timer() as t:
            with metrics.time("inference.engine_build_s"):
                eng = self.engine(sample_evidence)
            with metrics.time("inference.sweep_s"):
                self._sweep(eng, burnin_epochs, epochs, sample_evidence,
                            seed, epoch_offset)
                self._sync()
        metrics.observe("inference.run_s", t.interval)
        metrics.add("inference.epochs", epochs + burnin_epochs)
        metrics.add("inference.variable_updates",
                    float(self.cg.n_vars) * (epochs + burnin_epochs))
        self.inference_total_time += t.interval
        self.inference_epochs_done += epochs
        self._last_infer_s = t.interval

    def learn(self, burnin_epochs: int, epochs: int, stepsize: float,
              decay: float, regularization: int, reg_param: float,
              truncation: int, diagnostics: bool = False,
              verbose: bool = False, learn_non_evidence: bool = False,
              grad_agg: str = "mean", checkpoint: str = "",
              checkpoint_every: int = 100):
        """Dual-chain SGD through the learn kernels (the signature of
        numbskull_tpu/numbskull.py:424-469). Zero epochs keep the
        weights and the chains as they are. With ``checkpoint``, chunks
        as for :meth:`inference` (meta ``learn_epochs_done``), chunk c
        stepping from ``stepsize * decay**done``."""
        lp = LearnParams(regularization=regularization, reg_param=reg_param,
                         truncation=truncation,
                         learn_non_evidence=learn_non_evidence,
                         grad_agg=grad_agg)
        if checkpoint:
            # a fully resumed run runs no _learn_once (which sets the
            # timing): seed it for the diagnostics print
            self._last_learn_s = 0.0
            self._chunked(checkpoint, checkpoint_every, epochs,
                          "learn_epochs_done", "learning.resumes",
                          lambda n, done, seed: self._learn_once(
                              burnin_epochs if done == 0 else 0, n,
                              stepsize * decay ** done, decay, lp, seed,
                              done))
        elif epochs > 0:
            self._learn_once(burnin_epochs, epochs, stepsize, decay, lp,
                             self._next_seed())
        if diagnostics:
            print("FACTOR %d: learning %d epochs took %.3f sec" %
                  (self.fid, epochs, self._last_learn_s))
            if verbose:
                self.diagnosticsLearning()

    def _learn_once(self, burnin_epochs: int, epochs: int,
                    stepsize: float, decay: float, lp: LearnParams,
                    seed: int, epoch_offset=None):
        """One learning run, seeded as :meth:`_sweep` seeds inference;
        both chains continue from the current state."""
        with Timer() as t:
            with metrics.time("learning.engine_build_s"):
                eng = self.engine(True)
                if isinstance(eng, ItemGridEngine):
                    eng.learn_tables()
            with metrics.time("learning.sweep_s"):
                if isinstance(eng, GibbsEngine):
                    self.state = eng.learn(
                        self.state, seed, epochs, stepsize, decay,
                        burn=burnin_epochs, lp=lp,
                        epoch_offset=epoch_offset or 0)
                else:
                    w, x, xe = eng.learn(
                        seed if epoch_offset is None else
                        chunk_seed(seed, epoch_offset), burnin_epochs,
                        epochs, stepsize, decay, lp,
                        weight_value=self.state.weight_value,
                        x0=self.state.var_value,
                        xe0=self.state.var_value_evid)
                    self.state.weight_value = w
                    self.state.var_value = x
                    self.state.var_value_evid = xe
                self._sync()
        metrics.observe("learning.run_s", t.interval)
        metrics.add("learning.epochs", epochs)
        self.learning_total_time += t.interval
        self._last_learn_s = t.interval

    # --- getters / diagnostics (reference factorgraph.py:84-123) ----------

    def getWeights(self) -> np.ndarray:
        return self.state.weight_value.cpu().numpy()

    def _counts(self) -> np.ndarray:
        return self.state.count.cpu().numpy().astype(np.float64)

    def getMarginals(self, epochs: int | None = None) -> np.ndarray:
        """Marginals in the reference's cardinality-compressed layout."""
        epochs = epochs or self.inference_epochs_done or 1
        vrep, kidx = _out_layout_for(np.asarray(self.cg.var_card, np.int64))
        return self._counts()[vrep, kidx] / epochs

    def full_marginals(self, epochs: int | None = None) -> np.ndarray:
        """(V, K) marginal matrix."""
        epochs = epochs or self.inference_epochs_done or 1
        return self._counts() / epochs

    def diagnosticsLearning(self):
        print("Weights:")
        w = self.getWeights()
        for i in range(self.cg.n_weights):
            print("    weightId:", i)
            print("        isFixed:", bool(self.cg.weight_fixed[i]))
            print("        weight: ", float(w[i]))

    def diagnostics(self, epochs: int):
        print("Inference took %.03f sec." % self.inference_total_time)
        marg = self.getMarginals(epochs)
        hist, _ = np.histogram(marg, bins=10, range=(0.0, 1.0))
        for i in range(10):
            print("Prob. %.1f..%.1f: %d variables" %
                  (i / 10.0, (i + 1) / 10.0, hist[i]))

    # --- dumps (DimmWitted text format, reference factorgraph.py:210-229) --

    def dump_weights(self, fout: str):
        dump_weight_text(self.getWeights()[:self.cg.n_weights], fout)

    def dump_probabilities(self, fout: str, epochs: int):
        dump_marginal_text(self.cg, self._counts(), epochs, fout)


def _out_layout_for(card: np.ndarray):
    """Flat cstart output layout over a cardinality vector (binary
    vars: one slot, at k=1); see FactorGraph._out_layout."""
    if not len(card):
        z = np.zeros(0, np.int64)
        return z, z
    nsl = np.where(card == 2, 1, card)
    csum = np.cumsum(nsl)
    vrep = np.repeat(np.arange(len(card)), nsl)
    within = np.arange(csum[-1]) - np.repeat(csum - nsl, nsl)
    kidx = within + (card[vrep] == 2)
    return vrep, kidx


def dump_marginal_text(cg, counts: np.ndarray, epochs: int, fout: str):
    """DimmWitted `vid value prob` dump from a (V, K) count matrix
    (shared by FactorGraph and the distributed runner)."""
    epochs = epochs or 1
    card = np.asarray(cg.var_card, np.int64)
    vrep, kidx = _out_layout_for(card)
    prob = counts[vrep, kidx] / epochs
    dt = np.asarray(cg.var_dtype, np.int64)
    vo = np.asarray(cg.vtf_offset, np.int64)
    vmapv = np.asarray(cg.vmap_value, np.int64)
    binary = card[vrep] == 2
    # dense multi-valued variables: values ARE 0..card-1 (the
    # reference's dump reads past its single vmap slot here,
    # factorgraph.py:226-228 — a latent bug its tests never hit; we
    # write the identity values). Categorical: the original domain
    # value at this slot.
    dense_val = kidx
    if len(vmapv):
        dom_idx = np.minimum(vo[vrep] + kidx, len(vmapv) - 1)
        cat_val = vmapv[dom_idx]
    else:
        cat_val = kidx
    value = np.where(binary, 1,
                     np.where(dt[vrep] == 0, dense_val, cat_val))
    if _native_dump(fout, vrep, value, prob, 3):
        return
    with open(fout, "wb") as out:
        out.write(_format_cols((vrep, value, ("fixed", prob, 3))))


def dump_weight_text(weights: np.ndarray, fout: str):
    """DimmWitted `wid weight` dump."""
    w = np.asarray(weights, np.float64)
    ids = np.arange(len(w))
    if _native_dump(fout, ids, None, w, 6):
        return
    with open(fout, "wb") as out:
        out.write(_format_cols((ids, ("fixed", w, 6))))


class NumbSkull:
    """Main user-facing class; drop-in analog of the reference NumbSkull
    (numbskull/numbskull.py:152-391). ``device`` ('cuda' by default)
    holds every graph's sampler state."""

    def __init__(self, **kwargs):
        arg_defaults = {}
        for arg, opts in arguments:
            if arg[0] == "directory":
                arg_defaults["directory"] = opts["default"]
            else:
                arg_defaults[opts["dest"]] = opts["default"]
        for arg, opts in flags:
            arg_defaults[opts["dest"]] = opts["default"]
        for key, default in arg_defaults.items():
            setattr(self, key, kwargs.get(key, default))
        _check_engine(self.engine)
        self.device = resolve_device(self.device)
        self.factorGraphs: list[FactorGraph] = []

    # --- loading -----------------------------------------------------------

    def _add_graph(self, cg):
        self.factorGraphs.append(
            FactorGraph(cg, len(self.factorGraphs), seed=self.seed,
                        device=self.device, engine=self.engine))

    def loadFactorGraph(self, weight, variable, factor, fmap, domain_mask,
                        edges, var_copies=1, weight_copies=1,
                        factors_to_skip=np.empty(0, np.int64)):
        """Load a programmatically built graph (structured arrays)."""
        for name, arr, dtype in (("weight", weight, T.Weight),
                                 ("variable", variable, T.Variable),
                                 ("factor", factor, T.Factor),
                                 ("fmap", fmap, T.FactorToVar)):
            if not isinstance(arr, np.ndarray) or arr.dtype != dtype:
                raise TypeError("%s must be a numpy array of dtype "
                                "types.%s" % (name, name.capitalize()))
        cg = compile_graph(weight, variable, factor, fmap,
                           factors_to_skip=factors_to_skip,
                           max_colors=self.max_colors,
                           domain_mask=domain_mask,
                           seed=self.seed,
                           cache=self.plan_cache or None)
        self._add_graph(cg)

    def loadFactorGraphRaw(self, cg, var_copies=1, weight_copies=1):
        """Load a pre-compiled graph (CompiledGraph), skipping
        compilation (reference loadFactorGraphRaw, numbskull.py:183-190)."""
        self._add_graph(cg)

    def loadFGFromFile(self, directory=None, metafile=None, weightfile=None,
                       variablefile=None, factorfile=None, domainfile=None,
                       var_copies=1, weight_copies=1):
        """Load a DeepDive binary factor graph directory."""
        directory = directory or self.directory
        if not directory:
            print("No factor graph specified")
            return
        with metrics.time("load.files_s"):
            meta, weights, variables, factors, fmap, vmap, domain_mask = \
                dataloading.load_factor_graph_files(
                    directory,
                    metafile or self.metafile,
                    weightfile or self.weightfile,
                    variablefile or self.variablefile,
                    factorfile or self.factorfile,
                    domainfile or self.domainfile)
        if not self.quiet:
            print("Meta:")
            print("    weights:  ", meta["weights"])
            print("    variables:", meta["variables"])
            print("    factors:  ", meta["factors"])
            print("    edges:    ", meta["edges"])
        with metrics.time("load.compile_s"):
            cg = compile_graph(weights, variables, factors, fmap,
                               max_colors=self.max_colors,
                               domain_values=vmap["value"],
                               domain_mask=domain_mask,
                               seed=self.seed,
                               cache=self.plan_cache or None)
        if not self.quiet:
            print("chromatic schedule: %d colors" % cg.n_colors)
        self._add_graph(cg)

    def loadFGFromDB(self, dburl=None, sql_filter: str = "1=1",
                     is_master: bool = True):
        """Load a (partition of a) factor graph from a database.

        Reference analog: master/minion Postgres ingest
        (salt/src/numbskull_master.py:327-346,
        salt/src/numbskull_minion.py:142-188). Accepts any DB-API URL
        handled by ``dbsource.connect`` (postgresql:// or sqlite://)."""
        from numbskull_tpu_torch import dbsource
        with metrics.time("load.db_s"):
            conn = dbsource.connect(dburl or self.dburl)
            try:
                cur = conn.cursor()
                (weight, variable, factor, fmap, domain_mask, edges,
                 meta) = dbsource.get_fg_data(cur, sql_filter, is_master)
            finally:
                conn.close()
        if not self.quiet:
            print("DB graph: %d weights, %d variables, %d factors, "
                  "%d edges" % (len(weight), len(variable), len(factor),
                                edges))
        with metrics.time("load.compile_s"):
            self.loadFactorGraph(weight, variable, factor, fmap,
                                 domain_mask, edges)
        return meta

    def getFactorGraph(self, fgID: int = 0) -> FactorGraph:
        return self.factorGraphs[fgID]

    # --- inference / learning ----------------------------------------------

    def inference(self, fgID: int = 0, out: bool = True):
        fg = self.factorGraphs[fgID]
        fg.inference(self.burn_in, self.n_inference_epoch,
                     sample_evidence=self.sample_evidence,
                     diagnostics=not self.quiet,
                     checkpoint=self.checkpoint,
                     checkpoint_every=self.checkpoint_every)
        if out:
            os.makedirs(self.output_dir, exist_ok=True)
            with metrics.time("dump.marginals_s"):
                fg.dump_probabilities(
                    os.path.join(self.output_dir,
                                 "inference_result.out.text"),
                    self.n_inference_epoch)

    def learning(self, fgID: int = 0, out: bool = True):
        fg = self.factorGraphs[fgID]
        # learning checkpoints live beside the inference checkpoint in
        # their own file (the two runs share the --checkpoint flag)
        ck = self.checkpoint + ".learn" if self.checkpoint else ""
        fg.learn(self.burn_in, self.n_learning_epoch, self.stepsize,
                 self.decay, self.regularization, self.reg_param,
                 self.truncation, diagnostics=not self.quiet,
                 verbose=self.verbose,
                 learn_non_evidence=self.learn_non_evidence,
                 grad_agg=self.grad_agg, checkpoint=ck,
                 checkpoint_every=self.checkpoint_every)
        if out:
            os.makedirs(self.output_dir, exist_ok=True)
            fg.dump_weights(os.path.join(
                self.output_dir, "inference_result.out.weights.text"))


def _distributed_arrays(ns: "NumbSkull"):
    """Raw full-graph arrays and, from a database, its partition metadata
    (None for graph files) for the distributed runner."""
    if ns.dburl:
        from numbskull_tpu_torch import dbsource
        conn = dbsource.connect(ns.dburl)
        try:
            cur = conn.cursor()
            (weight, variable, factor, fmap, domain_mask, _e,
             meta) = dbsource.get_fg_data(cur, "1=1", is_master=True,
                                          mark_roles=False)
        finally:
            conn.close()
        return weight, variable, factor, fmap, domain_mask, meta
    _, weight, variable, factor, fmap, _, domain_mask = \
        dataloading.load_factor_graph_files(
            ns.directory, ns.metafile, ns.weightfile, ns.variablefile,
            ns.factorfile, ns.domainfile)
    return weight, variable, factor, fmap, domain_mask, None


def _ufo_covers_straddlers(factor, fmap, part, factor_ufo) -> bool:
    """Whether the UFO flags cover every factor whose variables lie in
    more than one part (its owner's and another)."""
    from numbskull_tpu_torch.parallel.bsp import factor_owner
    owner = factor_owner(factor, fmap, part)
    fvid = fmap["vid"].astype(np.int64)
    arity = factor["arity"].astype(np.int64)
    edge_fid = np.repeat(np.arange(len(factor)), arity)
    straddles = np.zeros(len(factor), bool)
    np.logical_or.at(straddles, edge_fid, part[fvid] != owner[edge_fid])
    return bool((factor_ufo | ~straddles).all())


def part_devices(device: torch.device) -> list:
    """The devices ``--parts`` spreads its parts over: every visible card
    when ``device`` is a CUDA device and more than one is visible (the
    JAX CLI hands BSPEngine ``jax.devices()``,
    numbskull_tpu/numbskull.py:838-842), else ``device`` alone."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [device]


def run_distributed(ns: "NumbSkull", out: bool = True,
                    devices=None) -> dict:
    """One-command partitioned learning + inference.

    The reference's whole cluster flow (load, partition by cost,
    distributed learning with per-epoch weight-delta reduction at the
    master, distributed inference, text dumps, wall times returned) as a
    single call (reference salt/src/numbskull_master.py:547-584; scheme
    selection by cost numbskull_master.py:371-408). Part p runs on
    ``devices[p % len(devices)]``, by default :func:`part_devices` of
    ``ns.device``. Partition candidates: the DB's partition keys (when
    present) compete against connected-components packing and balanced
    region growing under one cost model; the cheapest wins, and the
    result's ``costs`` holds every candidate's cost. ``--dist_mode
    auto`` picks ``messages`` when the DB's UFO flags cover every
    straddling factor, else ``values``. Wall times go to the metrics
    ``distributed.<phase>_s`` (partition, compile, learning, inference,
    dump)."""
    from numbskull_tpu_torch.compile import conflict_edges
    from numbskull_tpu_torch.parallel.bsp import BSPEngine
    from numbskull_tpu_torch.parallel.partition import (choose_partition,
                                                        partition_cost)

    devices = part_devices(ns.device) if devices is None else \
        [torch.device(d) for d in devices]
    n_parts = max(int(ns.parts), 1)
    (weight, variable, factor, fmap, domain_mask,
     meta) = _distributed_arrays(ns)
    edges = conflict_edges(variable, factor, fmap)

    with Timer() as t_part:
        part, report = choose_partition(len(variable), edges, n_parts)
        if meta is not None and (np.asarray(meta["var_pid"]) >= 0).any():
            from numbskull_tpu_torch.dbsource import partition_from_keys
            kp = partition_from_keys(meta["var_pt"], meta["var_pid"])
            key_cost = partition_cost(len(variable), edges, kp,
                                      int(kp.max()) + 1)
            report["keys"] = key_cost
            if key_cost < report[report["chosen"]]:
                part, report["chosen"] = kp, "keys"

    mode = ns.dist_mode
    if mode == "auto":
        mode = "messages" if meta is not None and "factor_ufo" in meta and \
            _ufo_covers_straddlers(factor, fmap, part,
                                   meta["factor_ufo"]) else "values"

    with Timer() as t_compile:
        eng = BSPEngine(weight, variable, factor, fmap, part, mode=mode,
                        domain_mask=domain_mask, max_colors=ns.max_colors,
                        seed=ns.seed, devices=devices)
    lp = LearnParams(regularization=ns.regularization,
                     reg_param=ns.reg_param, truncation=ns.truncation,
                     learn_non_evidence=ns.learn_non_evidence,
                     grad_agg=ns.grad_agg)
    gen = torch.Generator().manual_seed(int(ns.seed))
    states = eng.init_states()

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    with Timer() as t_learn:
        if ns.n_learning_epoch:
            states = eng.learn(states, gen,
                               epochs=ns.n_learning_epoch,
                               stepsize=ns.stepsize, decay=ns.decay,
                               burn=ns.burn_in, lp=lp)
        sync()
    with Timer() as t_inf:
        states = eng.inference(states, gen,
                               epochs=ns.n_inference_epoch,
                               burn=ns.burn_in,
                               sample_evidence=ns.sample_evidence)
        sync()
    with Timer() as t_dump:
        counts = eng.marginals(states, 1)
        weights_out = eng.weights(states)
        if out:
            os.makedirs(ns.output_dir, exist_ok=True)
            dump_weight_text(weights_out, os.path.join(
                ns.output_dir, "inference_result.out.weights.text"))
            dump_marginal_text(eng.engines[0].cg, counts,
                               ns.n_inference_epoch, os.path.join(
                                   ns.output_dir,
                                   "inference_result.out.text"))
    result = {
        "n_parts": n_parts, "mode": mode, "partition": report["chosen"],
        "costs": {k: float(v) for k, v in report.items() if k != "chosen"},
        "devices": [str(d) for d in eng.devices],
        "partition_s": t_part.interval, "compile_s": t_compile.interval,
        "learning_s": t_learn.interval, "inference_s": t_inf.interval,
        "dump_s": t_dump.interval, "traffic": eng.sync_traffic(),
    }
    for phase in ("partition", "compile", "learning", "inference", "dump"):
        metrics.observe("distributed.%s_s" % phase, result[phase + "_s"])
    if not ns.quiet:
        print("DISTRIBUTED %d parts (%s, %s): learning %.3f s, "
              "inference %.3f s" %
              (n_parts, result["partition"], mode,
               t_learn.interval, t_inf.interval))
    return result


def load(argv=None) -> NumbSkull:
    """Parse CLI args, build a NumbSkull, load the graph directory."""
    if argv is None:
        argv = sys.argv[1:]
    parser = argparse.ArgumentParser(
        description="Runs a Gibbs sampler on a GPU (PyTorch + CUDA)",
        epilog="")
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + "0.1.0")
    for arg, opts in arguments:
        parser.add_argument(*arg, **opts)
    for arg, opts in flags:
        parser.add_argument(*arg, **opts)
    args = parser.parse_args(argv)
    ns = NumbSkull(**vars(args))
    if ns.parts and ns.parts > 1:
        return ns      # run_distributed loads its own raw arrays
    if ns.dburl:
        ns.loadFGFromDB()
    else:
        ns.loadFGFromFile()
    return ns


def main(argv=None):
    ns = load(argv)
    if ns.parts and ns.parts > 1:
        ns.distributed = run_distributed(ns)
    else:
        ns.learning()
        ns.inference()
    if ns.metrics_out:
        metrics.dump(ns.metrics_out)
    return ns
