#!/usr/bin/env python3
"""Smoke test of the PyTorch port (numbskull_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each one that fails exits non-zero; nothing is retried; the
full run takes phase 13 right after phase 2):

1. Device: the card's name and power limit, the torch and CUDA versions,
   and the build (``make -C native``, then nvcc of the sweep, learn,
   exchange, lattice and gather kernels, all five at once), with the
   kernels' registers and the categorical learn kernels' blocks an SM.
2. Kernels against their plain versions on the card.
   Sweep: for coin, Ising 64x64, LF card 3, Potts card 20, 64 and 128,
   and grouped voting at degree 50 (arity 51), 5 burn-in plus 20
   tallied epochs from the same state through the CUDA kernel and
   through ``color_step_reference``, under the port's own schedule and
   under one that swaps every map and draw (so `row`, `tile`, `cdf`,
   `vec` and `sigmoid2` all run), and an Ising 64x64 compiled with
   max_colors=1 (one color whose rows read each other). Then the edges of
   the item kernel (kmax 2) under every map and draw: a star whose
   centre row holds 5000 items (more than a block's shared-memory chunk;
   its color is a one-row step) and an Ising 3x5 with two variables of
   cardinality 1 (steps of fewer rows than one tile). Dyadic weights
   make potential sums exact in any order, so values and counts must be
   bit-equal. Then the EHR-shape DP graph (20,000 candidates x 24 LFs)
   with sample_evidence off: its LF colours have no row to update, so
   ``ItemGridEngine.run`` launches one step an epoch and skips the
   others, bit-equal to the plain version, which runs every step. Then
   the coin model's marginals on the card against the exact joint.
   Learn: for coin, Ising 64x64 with 30 % evidence, LF card 3 (L1,
   learn_non_evidence, one fixed weight), Potts 32x32 card 64 and 128
   with evidence, voting degree 50 with 30 % evidence, 4096 ISTRUE
   weights (L1), the max_colors=1 Ising and a star whose centre row holds
   5000 items (more than a learn tile's budget, so summed in pieces;
   non-dyadic featureValues), 2 burn-in and 5 learning epochs from one
   state through the kernels and through ``learn_color_step_reference``,
   compared after every (epoch, color): weights and both chains must be
   bit-equal. Then an LF graph and a coin graph with non-dyadic
   featureValues each learn twice through the kernels: the two runs must
   agree bit for bit, and with the plain version.
   Categorical edges (``phase_cat_edges``; the categorical kernels at
   KMAX 8, 32 and 128): stars of 127, 128, 129 and 300 leaves at
   cardinality 8, 32 and 128 (steps of 1 and of that many rows, the
   centre's row longer than a chunk, its items sparse at 300) under
   every map and draw, and learning on them; the has_ext forms on the
   129-leaf stars; 2 shards (the `send` packs) of Potts 48x48 at card 20
   and 128, inference and learning; Potts 16x16 compiled with
   max_colors=1 (a conflicting step). All bit-equal to the plain
   versions.
   The categorical learn kernel's kept and re-read forms
   (``phase_kept_form``): a DP graph of 20,000 candidates x 24 LFs (the
   EHR shape, every step kept) under two learn settings, and bipartite
   graphs at cardinality 8, 32 and 40 whose steps launch tiles of both
   forms; weights and both chains bit-equal to the plain version.
   Lattice: ``grid_gibbs`` (kernel #8) against ``grid_gibbs_reference``
   from one lattice, x and count bit-equal, on odd and even sides, 1 x m
   and n x 1, 70000 rows or columns, weight 0.4 and -30, a bias,
   burn-in; at each tile and k of the plan's table, sides of T - 1, T,
   T + 1 and 2T + 1 and burn k - 1, k and k + 1 (chunks that start and
   end inside the burn-in); and at 1024x1024, 2048x2048 and 8192x8192
   over several chunks.
3. Main path, inference: a 1024x1024 Ising graph (1,048,576 boolean
   variables, 2,095,104 EQUAL factors, weight 0.25) written as
   DeepDive binary files, then ``numbskull_tpu_torch.numbskull.main``
   with -i 500 -b 50 --engine hbm on the GPU. Its outputs are checked,
   the engine asked for must be counted, and the kernel's launch count
   must be (500 + 50) x colors. Then the kernel is held bit for bit
   against the plain version on the CLI's own tables (2 burn-in plus 3
   tallied epochs, 524,288 rows per launch). Phases 3, 5, 7, 8 and 9
   print the sweep's device time per color (``torch.profiler``) and its
   kernels' registers and local memory.
4. Main path, learning: the coin graph with 200,000 copies (400,000
   variables, 600,000 factors, evidence drawn from the exact joint of
   weights (0.8, -0.5, 0.4)) as DeepDive files, then ``main`` with
   -l 150 -i 100 -b 10 -s 0.1 -d 0.99 -r 1e-4. The learned weights must
   be within 0.15 of the truth and both kernels' launches as counted;
   then the learn kernels are held bit for bit against the plain
   version on the CLI's own tables (2 burn-in plus 3 learning epochs).
5. Rates: epoch-differenced variable updates per second (CUDA events),
   kernel and plain version in turns, for inference on the graph of
   phase 3 and for learning on the graph of phase 4, and for both on a
   200,000-copy Snorkel-style LF graph (1.2 M variables), which is
   first held bit for bit against the plain versions as in phase 3;
   with the device busy share of each.
6. Main path, lattice: ``GridGibbsEngine`` (ops/stencil) at 1024x1024,
   weight 0.3, 50 burn-in and 200 tallied sweeps on the card, its launch
   count against the plan's (``lattice_plan``), and its mean marginal
   and equal-neighbour share against ``ItemGridEngine`` on
   ``ising_grid(1024, 1024, 0.3)``; then
   epoch-differenced rates of kernel and plain version at 1024, 2048 and
   8192 squared, with the device busy share and device time per kernel.
7. Main path, ``engine="hbm"``: the 4096x8192 Ising (33,554,432
   variables, 30 % evidence, learnable weight) through ``compile_graph``
   and ``FactorGraph(cg, engine="hbm")``: 2 + 10 inference epochs and
   1 + 3 learning epochs, timed by phase (model, compile, engine build,
   sweeps) with their launch counts; inference and learning rates, the
   device time per kernel, and the sweep and learn kernels held bit for
   bit against their plain versions on the path's own tables at full
   size (1 burn-in + 1 epoch each), with the plain epochs' times.
8. Main path, graph-sharded: ``MultiChipItemGridEngine`` on the Ising
   1024x1024 of phase 3 with 4 shards in one process: ``run`` and
   ``run_emulated`` (2 burn-in + 3 tallied epochs) bit-equal to each
   other and to the plain versions on the same shard tables; learning on
   the grid with a learnable weight and 30 % evidence (1 burn-in + 2
   epochs) bit-equal to plain; every launch as counted; epoch times at
   1, 2 and 4 shards with the exchange's share of the device time;
   learning at 1 and 4 shards with the device time per kernel; the
   unpack kernel, its plain version and ``index_copy_`` at one replica's
   share (medians of each call's device time, kernel and ``index_copy_``
   in turns); then 2 processes on the one card over a gloo group (file store
   in a temporary directory), whose values, counts and learned weights
   must equal the in-process 2-shard run bit for bit.

9. Partitioned (BSP) execution: (a) ``BSPItemGridInference`` on the
   Ising of phase 3, 4 parts from ``choose_partition`` (as the CLI
   chooses them), ``values`` and ``messages`` mode, 2 burn-in + 10
   syncs through the kernels (counted: the has_ext sweep runs in
   messages mode only) and through the plain versions from the same
   state, values and tallies bit-equal; ms per sync, its split (part
   sweeps, messages, exchange) and the device busy share; the has_ext
   sweep's device time per launch against the same launch without the
   table. (b) messages-mode learning, kernels against plain bit for bit
   (weights, both chains), on the coin graph of phase 4 split pairwise
   (2 burn-in syncs + 3 epochs) and on the 1M Ising with 30 % evidence
   in 4 parts (2 epochs), with the learning sync's rate and split. (c)
   The CLI: ``--parts 4 -i 100 -b 10`` on the Ising and ``--parts 2 -l
   150 -i 100 -b 10`` on the coin graph (``BSPEngine`` over the
   tensor-op ``GibbsEngine``), outputs checked, ``main()`` split into
   partition, per-part compile, learning, inference and dump.
10. Graphs the kernels refuse, the gather kernels, the experiment
   drivers: (a) the CLI (``--engine itemgrid --device cuda``) on a 4x4
   Potts graph of cardinality 130 (``-l 20 -i 200 -b 10``, 30 %
   evidence) and on ``voting_model(400, 1, 300)`` (301 colors, ``-i
   10``): both files written, one fallback counted with its warning,
   the tensor-op engine's tensors on the card, no sweep or learn kernel
   launched. (b) ``gather_sum`` and ``shifted_sum`` (TPU kernels #10 and
   #11): every kernel's registers and local memory (any spill fails);
   both against their plain versions bit for bit in every TPU mode at
   the TPU scripts' shapes, at ragged R (1, 1023, 4097) with the window
   staged in shared memory and not, and at the sweep kernel's sizes: R
   = 1,048,576 outputs of 59 gathers from a 4 MB x (A) and a 256 MB x
   (B), and span-8 shifts of a 256 MB window, with kernel, plain and
   ``embedding_bag`` times, the bound, B's sector bound and span 8's
   no-reuse time (every window once from device memory);
   the time at 2k iterations must be 1.8-2.2x the time at k, k doubled
   from 1000 until the call at k takes 1 ms (a hoisted loop fails). (c)
   Ten drivers of ``numbskull_tpu_torch/experiments`` (M6's seven,
   ``gather_rates``, ``scaling`` and ``multiproc_scaling``, the last
   with one 2-process gloo mesh) at a smoke size, their TSVs checked
   (columns, ``ok``, ``engine``): the main path of both gather kernels.
11. Checkpoints, ``--engine xla``, the DB source, ``burnIn`` and the
   profiler hooks, each path driven with the launch counts set to 0
   just before it and read just after: (a) the CLI on the Ising of
   phase 3 with ``-i 120 -b 10 --checkpoint --checkpoint_every 40``
   (kernel #1), whole and interrupted at 80 then resumed: marginals file
   and tallies bit-equal, the checkpoint's bytes and the seconds to save
   and load it; (b) ``-l 120 -i 5`` the same way on the coin graph of
   phase 4 (kernel #2): weights file and both chains bit-equal; (c)
   ``--engine xla`` on the Ising (no kernel launched): in chunks of 40
   == one call, bit for bit, marginals within Monte-Carlo error of (a)'s,
   ms per epoch; (d) ``resilience.run_resilient`` on ``GibbsEngine`` on
   the coin graph with faults at chunks 1 and 3 == the run without; (e)
   the coin graph published with ``dbsource.write_graph_to_db`` to a
   sqlite file, then ``-u sqlite://`` learning and inference == the run
   of ``loadFactorGraph`` on ``get_fg_data``'s arrays, the DB load time;
   (f) the coin graph keyed B / D1 with UFO flags on the straddling
   factors: ``--parts 2 -u`` costs the keys and picks ``messages``, and
   ``bsp_from_db(itemgrid=True)`` on the card (kernel #1 ``has_ext``)
   == ``BSPItemGridInference`` on the same arrays and part through the
   plain versions; (g) ``burnIn(3, True)`` on the card, a
   ``observability.trace`` around one more chunk of (a) holding the
   ``nsx.chunk`` region and the sweep kernel, and
   ``device_memory_stats``.
12. The (chains, graph) mesh engine (``parallel/sharded.
   ShardedGibbsEngine``, tensor ops, no kernel of its own: no itemgrid
   launch is allowed) on the Ising of phase 3 for inference (2 burn-in +
   5 epochs) and on phase 8's learnable grid with 30 % evidence for
   learning (1 burn-in + 2 epochs, L2; and 2 epochs of an L1 schedule
   whose weights stay dyadic): (a) the in-process (1, 1) mesh ==
   ``GibbsEngine`` seeded ``chain_seed(seed, 0)``, values, counts,
   weights and both chains bit-equal; (b) in-process (1, 2), (1, 4),
   (2, 1) and (2, 2): chain c of every shape == chain c of (2, 1) in
   inference, graph-sharded learning == the unsharded shape with the
   same chains, the pooled marginals finite and near 0.5; (c) 4 gloo
   processes on the card as a (2, 2) ``global_mesh``: every rank ==
   the in-process (2, 2) chain it runs, and a world of one ``nccl``
   process at (1, 1) == (a); (d) ms per inference and learning epoch at
   each shape and in both process runs, with the share of the wall time
   spent in the axis sums (the collectives).
13. Every factor function through kernels #1 and #2: (a) random graphs
   with dyadic weights (``random_graph``, ``dp_graph``): each of the 25
   codes alone, boolean at arity 1 to 4, at arity 13 (the 8-lane item
   path; codes of free arity), with one row of 1,100 items (1 lane;
   at KMAX 2 a tile of its own past ITEM_TILE, so the learn step kernel,
   where every other KMAX-2 step, its tiles cut at ITEM_CUT items, runs
   the learn item kernel) and at cardinality 3 to 8, 3 to 32
   and 3 to 128 (the categorical kernels at KMAX 8, 32, 128; at 8 and
   32 with a row too wide for the learn kernel's kept form, so that
   both learn kernels run), each under every map x draw; then every
   code mixed on
   boolean and on categorical variables, and the DP model, under
   ``GROUP_SCHEDULES``; each also learning under L2 and, but for the
   hub, a13, cat32 and cat128 graphs, L1 with learn_non_evidence and
   ``grad_agg="sum"``: every draw, count and
   weight equal to the plain version, each code's sweep paths (item
   lanes and FAST, row template) and learn templates logged, and a code
   that missed a path that takes it fails; (b) on every graph of (a),
   ``ops/gibbs.color_potentials`` within 1e-4 x max(1, |potential|) of
   ``golden.potential`` at a random state; (c) on three small graphs
   (boolean, categorical, DP) the kernel's marginals over 20,000 epochs
   within 0.02 of ``golden.exact_marginals``; (d) a data-programming model of 200,000
   candidates x 10 LFs (2.2 M variables, 9 M factors) through the CLI
   with ``-l 20 -i 100 -b 10 --engine itemgrid`` (the launches as
   counted, no fallback) and ``--engine xla``: the class variables'
   mean marginal and every learned weight within DP_TOL_*; the kernels
   against the plain versions on the CLI's tables; compile, build and
   epoch-differenced epoch times of kernel and plain version; (e) Potts
   256x256 at cardinality 128 with 30 % evidence through
   ``ItemGridEngine.run`` and ``.learn`` (launches counted), kernels
   against plain versions, epoch times of both; (f) DeepDive's spouse
   graph's shape at KMAX 2 (``spouse_shape``: rows of 10 to 62 ISTRUE
   and IMPLY items, runs of 128 rows far past ITEM_CUT items) takes the
   learn item kernel in every step, and its learning with non-dyadic
   featureValues equals the plain version bit for bit.

The line before the last is the kernels' JSON record (per kernel: main
path launches, largest difference from the plain version, ms per epoch
of kernel and plain version (the has_ext forms: per part-epoch on one
part's tables of the 1M Ising; the gathers: per call at shape A and at
the span-8 shape), the bound from this run's shapes at the H100's
3.35 TB/s and 67 TFLOP/s float32 (the lattice's per pipe: int32 at 64
lanes per SM and clock), and under ``hbm`` the 33.5 M path that
kernels #6 and #7 of the TPU package served; #1 and #2 also carry
phase 13's DP graph under ``dp`` and its card-128 Potts grid under
``potts128``: the categorical kernels); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is visible or the port's package is not beside this
script. ``python3 chip_smoke.py mc`` runs phases 1 and 8 only,
``python3 chip_smoke.py bsp`` phases 1 and 9, ``python3 chip_smoke.py
gather`` phases 1 and 10, ``python3 chip_smoke.py learn`` phases 1, 2
(learning), 4, 5 (learning and LF inference) and 7, ``python3
chip_smoke.py sweep`` phases 1, 2 (the sweep), 3 with the sweep's rates
on its graph, and 7, ``python3 chip_smoke.py lattice`` phases 1, 2 (the
lattice) and 6, ``python3 chip_smoke.py checkpoint`` phases 1 and 11,
with a kernels line of kernels #1 and #2 from phase 11's own runs,
``python3 chip_smoke.py sharded`` phases 1 and 12, with an empty
kernels line (no kernel runs on the mesh engine's path), ``python3
chip_smoke.py factors`` phases 1 and 13, with a kernels line of kernels
#1 and #2 on phase 13's DP graph (and its Potts grid under
``potts128``), ``python3 chip_smoke.py categorical`` phases 1, 2's
categorical edges and kept and re-read forms and 13, with the same
line, ``python3 chip_smoke.py kept`` phases 1 and 2's kept and
re-read forms (empty kernels line), and ``python3
chip_smoke.py dpspread`` phase 1 and the spread over three seeds that
DP_TOL_* are three times of (empty kernels line).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
GRID = 1024              # phase 3 Ising side
COIN_COPIES = 200000     # phase 4 coin graph copies
LF_COPIES = 200000       # phase 5 LF graph copies
# the sweep kernels' records carry the design they run
REDESIGNED = "redesigned: item-parallel at kmax 2, packed tables"
SWEEP = {"name": "itemgrid_sweep", "route": "cuda",
         "source": "numbskull_tpu_torch/csrc/itemgrid_sweep.cu",
         "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:1597",
         "status": REDESIGNED}
LEARN = {"name": "itemgrid_learn", "route": "cuda",
         "source": "numbskull_tpu_torch/csrc/itemgrid_learn.cu",
         "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:2045"}
STENCIL = {"name": "stencil_gibbs", "route": "cuda",
           "source": "numbskull_tpu_torch/csrc/stencil_gibbs.cu",
           "replaces": "numbskull_tpu/ops/stencil_pallas.py:29",
           "status": "redesigned: k sweeps a launch on shared-memory "
                     "tiles, one thread per updated cell"}
MC_SWEEP = {"name": "itemgrid_mc_sweep", "route": "cuda",
            "source": "numbskull_tpu_torch/csrc/itemgrid_sweep.cu",
            "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:3259",
            "status": REDESIGNED}
MC_LEARN = {"name": "itemgrid_mc_learn", "route": "cuda",
            "source": "numbskull_tpu_torch/csrc/itemgrid_learn.cu",
            "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:3348"}
MC_ONE_COLOR = {"name": "itemgrid_mc_one_color", "route": "cuda",
                "source": "numbskull_tpu_torch/csrc/itemgrid_sweep.cu",
                "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:3478",
                "status": REDESIGNED}
EXCHANGE = {"name": "itemgrid_exchange", "route": "cuda",
            "source": "numbskull_tpu_torch/csrc/itemgrid_exchange.cu",
            "replaces": "tests/test_itemgrid_mc.py:112"}
MC_SHARDS = 4            # phase 8's in-process shard count
SWEEP_EXT = {"name": "itemgrid_sweep_ext", "route": "cuda",
             "source": "numbskull_tpu_torch/csrc/itemgrid_sweep.cu",
             "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:1862",
             "status": REDESIGNED}
LEARN_EXT = {"name": "itemgrid_learn_ext", "route": "cuda",
             "source": "numbskull_tpu_torch/csrc/itemgrid_learn.cu",
             "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:2351"}
GATHERED = "redesigned: index loads batched ahead of the gathers, an " \
    "output's terms split over a block where R is small, shifts sorted"
GATHER = {"name": "gather_sum", "route": "cuda",
          "source": "numbskull_tpu_torch/csrc/gather_bench.cu",
          "replaces": "experiments/micro_gather.py:39", "status": GATHERED}
SHIFTED = {"name": "shifted_sum", "route": "cuda",
           "source": "numbskull_tpu_torch/csrc/gather_bench.cu",
           "replaces": "experiments/micro_gather2.py:34", "status": GATHERED}
# phase 10 (b)'s ragged rows: R on both paths (a window staged in shared
# memory, and one of GATHER_GLOBAL_NX floats beyond it), ng and iters
GATHER_RAGGED_R = (1, 1023, 4097)
GATHER_GLOBAL_NX = 1 << 20
GATHER_RAGGED = ((59, 1), (59, 3), (4, 2))
VOTE_EPOCHS = 10         # phase 10's 301-color graph: 301 tensor-op
#                          color steps per epoch
BSP_PARTS = 4            # phase 9's parts on the 1M Ising
BSP_RUN = (3, 2, 10)     # phase 9's inference: seed, burn, epochs
COIN_TRUTH = (0.8, -0.5, 0.4)
CKPT = (120, 80, 40, 10)  # phase 11: epochs, interrupted at, chunk, burn-in
CKPT_LEARN = ["-s", "0.1", "-d", "0.99", "-r", "1e-4"]
LATTICE_W = 0.3          # bench.py:48 and :62, the lattice cells' weight
LATTICES = (1024, 2048, 8192)    # bench.py:375, :381; 8192 beyond VMEM
# (n, m, weight, bias, burn, epochs): odd and even sides, one row, one
# column, the antiferromagnet, a bias, burn-in, 70000 rows or columns;
# stencil_edge_fixtures adds the plan's tile and chunk edges
STENCIL_FIXTURES = ((8, 8, 0.4, 0.0, 0, 6), (33, 17, 0.4, 0.0, 2, 6),
                    (32, 48, 0.4, 0.0, 2, 6), (1, 37, 0.4, 0.2, 1, 8),
                    (41, 1, 0.4, -0.2, 1, 8), (16, 16, -30.0, 0.0, 2, 6),
                    (19, 24, 0.3, 0.7, 5, 5), (1, 1, 0.4, 0.3, 3, 9),
                    (70000, 3, 0.4, 0.1, 1, 2), (3, 70000, 0.4, 0.1, 1, 2))
LATTICE_RUN = (9, 20)    # phase 2's (burn, epochs) at the LATTICES sizes
HBM_GRID = (4096, 8192)  # bench.py:199, the 33,554,432-variable Ising
# the learn step kernels' and the sweep kernels' names
# (csrc/itemgrid_learn.cu, csrc/itemgrid_sweep.cu), in a trace
LEARN_STEP_KERNELS = ("learn_step_kernel", "learn_item_kernel",
                      "learn_cat_kernel", "learn_kept_kernel")
SWEEP_KERNELS = ("sweep_item_kernel", "sweep_cat_kernel")
# the sweep kernels as nsx_itemgrid_sweep_attrs numbers them
SWEEP_ATTRS = tuple("sweep_item_kernel<%d, %s>" % (lanes, fast)
                    for fast in ("false", "true")
                    for lanes in (1, 2, 4, 8, 16, 32)) + tuple(
    "sweep_cat_kernel<%d>" % k for k in (8, 32, 128))
# the learn kernels as nsx_learn_attrs numbers them
LEARN_ATTRS = ("learn_item_kernel", "learn_step_kernel") + tuple(
    "learn_cat_kernel<%d>" % k for k in (8, 32, 128)) + (
    "learn_sum_kernel", "learn_apply_kernel") + tuple(
    "learn_kept_kernel<%d>" % k for k in (8, 32, 128))
# learn_item_kernel spills at its 64-register cap (__launch_bounds__
# (kTileRows, 8)): printed, not failed (PERF.md)
KNOWN_SPILLS = ("learn_item_kernel",)


def fail(msg: str):
    print("chip_smoke FAILED: " + msg, file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str):
    print(msg, flush=True)


def setup():
    """Import torch and the port; fail without a GPU or a checkout."""
    if not os.path.isdir(os.path.join(HERE, "numbskull_tpu_torch")):
        fail("numbskull_tpu_torch/ is not beside chip_smoke.py: run it "
             "from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    return torch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    log("== phase 1: device and build")
    log("card: " + card_line())
    log("torch %s, CUDA %s, python %s" % (torch.__version__,
                                          torch.version.cuda,
                                          sys.version.split()[0]))
    t0 = time.perf_counter()
    make = subprocess.run(["make", "-C", os.path.join(HERE, "native"), "-s"],
                          capture_output=True, text=True, timeout=600)
    if make.returncode != 0:
        fail("make -C native failed:\n" + make.stdout + make.stderr)
    log("native helpers built in %.2f s" % (time.perf_counter() - t0))
    from numbskull_tpu_torch.ops import (_build, gather, itemgrid,
                                         stencil_kernel)
    t0 = time.perf_counter()
    errors = {}
    loaders = {"itemgrid_sweep": lambda: itemgrid._kernel_lib(),
               "itemgrid_learn": lambda: itemgrid._kernel_lib(
                   "itemgrid_learn"),
               "itemgrid_exchange": lambda: itemgrid._kernel_lib(
                   "itemgrid_exchange"),
               "stencil_gibbs": stencil_kernel._kernel_lib,
               "gather_bench": gather._kernel_lib}

    def build(name):
        try:
            loaders[name]()
        except Exception as err:          # reported below, then fail
            errors[name] = err

    threads = [threading.Thread(target=build, args=(name,))
               for name in loaders]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail("kernel build failed: %s" % errors)
    log("kernels loaded in %.2f s, all %d built at once" %
        (time.perf_counter() - t0, len(loaders)))
    for name in loaders:
        info = _build.BUILD_INFO.get(name)
        log("  %s: nvcc %s" % (name, "%.2f s" % info["seconds"] if info
                               else "cached"))
        if info:
            # the sweep, learn, lattice and gather kernels' whole report
            # (entry, registers, shared memory, spills), the others'
            # register and spill lines
            for line in info["ptxas"].splitlines():
                if name in ("itemgrid_sweep", "itemgrid_learn",
                            "stencil_gibbs", "gather_bench") or \
                        "registers" in line or "spill" in line:
                    log("    ptxas: " + line.strip())
    log("  " + sweep_resources())
    log("  " + learn_resources())
    log("  " + learn_occupancy())
    for n in LATTICES:
        plan = stencil_kernel.lattice_plan(n, n, 250)
        log("  lattice %dx%d plan %s: block %s, %d B dynamic shared memory"
            % (n, n, plan, plan.block, plan.shared_bytes))


def _kernel_attrs(fn, names) -> list:
    """(name, registers, local bytes a thread) of kernels ``names`` as
    the loaded module reports them (cudaFuncGetAttributes through
    ``fn(which, &regs, &local)``); a categorical kernel with local
    memory (a spill or a local array) fails the run."""
    out = []
    for which, name in enumerate(names):
        regs, local = ctypes.c_int(), ctypes.c_int()
        rc = fn(which, ctypes.byref(regs), ctypes.byref(local))
        if rc != 0:
            fail("cudaFuncGetAttributes of %s: CUDA error %d" % (name, rc))
        if ("_cat_kernel" in name or "_kept_kernel" in name) and \
                local.value:
            fail("%s uses %d B of local memory a thread (a spill or a "
                 "local array)" % (name, local.value))
        out.append((name, regs.value, local.value))
    return out


def _attrs_line(label, rows) -> str:
    return label + ": " + "; ".join(
        "%s %d registers, %d B local%s" % (n, r, lb, " (known spill)"
                                          if n in KNOWN_SPILLS and lb
                                          else "")
        for n, r, lb in rows)


def sweep_resources() -> str:
    """The sweep kernels' registers and local memory per thread (spills
    and local arrays) as the loaded module reports them
    (cudaFuncGetAttributes); local memory in a categorical kernel
    fails."""
    from numbskull_tpu_torch.ops import itemgrid
    return _attrs_line("sweep kernels", _kernel_attrs(
        itemgrid._kernel_lib().nsx_itemgrid_sweep_attrs, SWEEP_ATTRS))


def learn_resources() -> str:
    """The same for the learn kernels: local memory in a categorical
    learn kernel fails; learn_item_kernel's spill (KNOWN_SPILLS) is
    printed."""
    from numbskull_tpu_torch.ops import itemgrid
    return _attrs_line("learn kernels", _kernel_attrs(
        itemgrid._kernel_lib("itemgrid_learn").nsx_learn_attrs,
        LEARN_ATTRS))


def learn_occupancy() -> str:
    """Blocks an SM of each categorical learn kernel at kmax KMAX, with
    the dynamic shared memory of a DP step's tile (kmax 3, 540 items) and
    with the largest a launch asks for there (a tile of TILE_ITEMS items,
    or cat_pot_rows rows' potentials), as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    fn = pig._kernel_lib("itemgrid_learn").nsx_learn_occupancy
    out = []
    for name, first in (("learn_cat_kernel", 2), ("learn_kept_kernel", 7)):
        for which, k in enumerate((8, 32, 128), first):
            got = []
            for kmax, items in ((3, 540), (k, pig.TILE_ITEMS)):
                pots = 8 * pig.cat_pot_rows(kmax) * pig.cat_stride(kmax)
                smem = (max(pots, 5 * items) + 15) & ~15
                blocks = ctypes.c_int()
                rc = fn(which, pig.TILE_ROWS, smem, ctypes.byref(blocks))
                if rc != 0:
                    fail("occupancy of %s<%d>: CUDA error %d"
                         % (name, k, rc))
                got.append("%d at %d B" % (blocks.value, smem))
            out.append("%s<%d> %s" % (name, k, ", ".join(got)))
    return "learn blocks an SM: " + "; ".join(out)


def log_sweep(label, by_kernel):
    """Log the sweep kernels' device time per launch, one launch per
    color, from a trace's ``by_kernel`` (device_busy), then their
    registers and local memory; returns {kernel: ms per launch}."""
    out = {}
    for name, (calls, us) in sorted(by_kernel.items()):
        kern = next((k for k in SWEEP_KERNELS if k in name), None)
        if kern is not None:
            out[kern] = us / 1e3 / calls
            log("  %s: %s %d launches in the trace, %.5f ms per color"
                % (label, kern, calls, out[kern]))
    if not out:
        log("  %s: no sweep kernel in the trace" % label)
    log("  " + sweep_resources())
    return out


def _fixtures():
    """Small graphs with dyadic weights covering every kernel template
    (kmax 2, 8, 32, 128), arity up to 51, and 51 colors."""
    import numpy as np

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch import models as M

    def cg(t, **kw):
        w, v, f, fm, dm, _ = t
        return compile_graph(w, v, f, fm, domain_mask=dm, **kw)

    out = []
    out.append(("coin", cg(M.coin_model(4096, evidence=False,
                                        weight_init=(0.5, -0.25, 0.5),
                                        fixed=True)), True))
    t = M.ising_grid(64, 64, weight=0.25)
    t[1]["isEvidence"][::7] = 1
    out.append(("ising64x64_clamped", cg(t), False))
    t = M.lf_model(0.5, [0.5, 0.25, 0.75], copies=2000, seed=1)
    t[0]["initialValue"] = [0.5, 0.25, -0.5, 0.75]
    t[0]["isFixed"] = True
    out.append(("lf_card3", cg(t), True))
    for card in (20, 64, 128):
        out.append(("potts32x32_card%d" % card,
                    cg(M.potts_grid(32, 32, card=card, weight=0.25),
                       color_hint=M.ising_color_hint(32, 32)), True))
    out.append(("voting_degree50", cg(M.voting_grouped(
        10000, 50, weight=0.5, evidence_frac=0.1)), True))
    assert max(int(np.asarray(c.plans[0].it_arity).max())
               for n, c, _ in out if n.startswith("voting")) == 51
    return out


def _edge_fixtures():
    """The item kernel's edges (kmax 2), with dyadic weights: a star
    whose centre row holds 5000 EQUAL items (more than a block's
    SWEEP_CHUNK; its color is a one-row step, the other a step of 5000
    one-item rows) and an Ising 3x5 with two variables of cardinality 1
    (two steps of fewer rows than one tile). Then, run under two
    schedules only (``GROUP_SCHEDULES``), grouped voting at degree 12
    (items of arity 13, evaluated by 8 lanes each) with each factor type
    that reads more than one fact of its arguments, and with OR and
    EQUAL, and at degree 1 (arity 2, one lane an item) with IMPLY and
    LINEAR: every item kernel, fast or not."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_grid, voting_grouped
    n = 5000
    rng = np.random.default_rng(12)
    v = T.new_variables(n + 1)
    v["initialValue"] = rng.integers(0, 2, n + 1)
    v["cardinality"] = 2
    w = T.new_weights(2)
    w["initialValue"] = (0.25, -0.5)
    w["isFixed"] = True
    f = T.new_factors(n)
    f["factorFunction"] = T.FUNC_EQUAL
    f["weightId"] = np.arange(n) % 2
    f["featureValue"] = 1.0
    f["arity"] = 2
    f["ftv_offset"] = 2 * np.arange(n)
    fm = T.new_fmap(2 * n)
    fm["vid"][0::2] = 0
    fm["vid"][1::2] = np.arange(1, n + 1)
    out = [("star5000", compile_graph(w, v, f, fm))]
    w, v, f, fm, dm, _ = ising_grid(3, 5, weight=0.5)
    v["cardinality"][[0, 7]] = 1
    v["initialValue"] = rng.integers(0, 2, 15) % v["cardinality"]
    out.append(("ising3x5_card1", compile_graph(w, v, f, fm,
                                                domain_mask=dm)))
    for func, degree in (("IMPLY_NATURAL", 12), ("IMPLY_MLN", 12),
                         ("LINEAR", 12), ("RATIO", 12), ("LOGICAL", 12),
                         ("OR", 12), ("EQUAL", 12), ("IMPLY_NATURAL", 1),
                         ("LINEAR", 1)):
        w, v, f, fm, dm, _ = voting_grouped(
            1300 if degree > 1 else 4000, degree, weight=0.5,
            func=T.FACTORS[func], evidence_frac=0.1, seed=len(func))
        out.append(("voting%d_%s" % (degree, func.lower()),
                    compile_graph(w, v, f, fm, domain_mask=dm)))
    return out


GROUP_SCHEDULES = ("row/cdf", "tile/sigmoid2")


def _every_map_and_draw(schedule):
    """One schedule per (map, draw): every step with that map and draw."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    n = len(schedule.colors)
    return [("%s/%s" % (m, d), pig.Schedule(
        colors=schedule.colors, maps=(m,) * n, draws=(d,) * n,
        upos=schedule.upos)) for m in pig.MAPS for d in pig.DRAWS]


def _swapped(schedule):
    """Every map and draw swapped: tile for row; on non-boolean colors
    vec for cdf and cdf for vec."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    swap = {"cdf": "vec", "vec": "cdf", "sigmoid2": "sigmoid2"}
    return pig.Schedule(colors=schedule.colors,
                        maps=("tile",) * len(schedule.colors),
                        draws=tuple(swap[d] for d in schedule.draws),
                        upos=schedule.upos)


def compare(torch, eng, seed=7, burn=5, epochs=20):
    """Lockstep kernel vs plain run from one state on the card, over the
    engine's own tables. Returns (equal draws, draws, max abs
    difference of values and counts)."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    cg, t, dev = eng.cg, eng.tables, eng.device
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32, device=dev)
    xk = torch.tensor(cg.var_init, dtype=torch.int32, device=dev)
    xp = xk.clone()
    ck = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32, device=dev)
    cp = ck.clone()
    s977 = pig.seed977_of(seed)
    equal = total = 0
    for epoch in range(burn + epochs):
        for ci in range(t.n_steps):
            pig.sweep_color(t, ci, xk, ck, w, s977, epoch, epoch >= burn)
            pig.color_step_reference(t, ci, xp, cp, w, s977, epoch,
                                     epoch >= burn)
            lo, n = t.row0[ci], t.n_rows[ci]
            vid = t.row_vid[lo:lo + n].to(torch.int64)
            equal += int((xk[vid] == xp[vid]).sum())
            total += n
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = max(int((xk - xp).abs().max()), int((ck - cp).abs().max()))
    return equal, total, err


def check_equal(torch, name, label, eng, **kw):
    """compare(), logged; fails on any unequal draw or count. Returns
    the max abs difference (0)."""
    eq, tot, err = compare(torch, eng, **kw)
    log("  %-22s %-13s kmax %3d colors %2d: %d of %d draws equal, "
        "max |diff| %d" % (name, label, eng.cg.kmax, eng.cg.n_colors, eq,
                           tot, err))
    if eq != tot or err != 0:
        fail("kernel and plain version disagree on %s (%s schedule)"
             % (name, label))
    return err


def phase_compare(torch):
    """Phase 2; returns the largest kernel-vs-plain difference seen."""
    import numpy as np

    from numbskull_tpu_torch.ops import itemgrid as pig
    log("== phase 2: kernel vs plain version on the card (bit-equal)")
    worst = 0
    seen = set()
    for name, cg, se in _fixtures():
        base = pig.default_schedule(cg)
        for label, sched in (("own", base), ("swapped", _swapped(base))):
            eng = pig.ItemGridEngine(cg, sample_evidence=se, device=DEVICE,
                                     schedule=sched)
            worst = max(worst, check_equal(torch, name, label, eng))
            seen |= {(m, d) for m, d in zip(sched.maps, sched.draws)}
    want = {(m, d) for m in pig.MAPS for d in pig.DRAWS}
    if seen != want:
        fail("maps x draws not all exercised: %s" % sorted(want - seen))
    eng = pig.ItemGridEngine(_ising_one_color(), device=DEVICE)
    if eng.tables.conflict != [True]:
        fail("max_colors=1 Ising: the one color is not marked conflicting")
    worst = max(worst, check_equal(torch, "ising64_max_colors1", "own",
                                   eng))
    for name, cg in _edge_fixtures():
        scheds = _every_map_and_draw(pig.default_schedule(cg))
        kw = {}
        if name.startswith("voting"):
            scheds = [s for s in scheds if s[0] in GROUP_SCHEDULES]
            kw = dict(burn=2, epochs=5)
        for i, (label, sched) in enumerate(scheds):
            eng = pig.ItemGridEngine(cg, device=DEVICE, schedule=sched)
            t = eng.tables
            if i == 0:
                log("  %s: steps %d, rows %d..%d, longest row %d items, "
                    "(tile rows, lanes) %s" % (
                        name, t.n_steps, min(t.n_rows), max(t.n_rows),
                        int(t.row_item.diff().max()),
                        sorted(set(t.item_shape))))
            worst = max(worst, check_equal(torch, name, label, eng, **kw))
    worst = max(worst, check_dead_steps(torch))

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import coin_exact_marginal, coin_model
    a, b, c = 0.3, -0.2, 0.4
    w, v, f, fm, dm, _ = coin_model(1000, evidence=False,
                                    weight_init=(a, b, c), fixed=True)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = pig.ItemGridEngine(cg, device=DEVICE)
    _, counts = eng.run(seed=11, burn=100, epochs=4000)
    marg = counts.cpu().numpy().astype(np.float64) / 4000
    exact = coin_exact_marginal(a, b, c)
    got = (marg[0::2, 1].mean(), marg[1::2, 1].mean())
    want_m = (exact[2] + exact[3], exact[1] + exact[3])
    log("  coin marginals on the card: P(x1)=%.4f (exact %.4f), "
        "P(x2)=%.4f (exact %.4f)" % (got[0], want_m[0], got[1],
                                      want_m[1]))
    if max(abs(got[0] - want_m[0]), abs(got[1] - want_m[1])) > 0.02:
        fail("coin marginals off the exact joint by more than 0.02")
    return worst


def check_dead_steps(torch):
    """Phase 2, dead steps: the EHR-shape DP graph (KEPT_DP) with
    sample_evidence off, whose LF colours have no row to update. The
    kernel route launches its one live step an epoch and skips the
    others (``sweep.skipped_steps``); the plain version runs every step;
    values and tallies equal bit for bit. Returns the max abs difference
    (0)."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    cand, lfs = KEPT_DP
    eng = pig.ItemGridEngine(compile_graph(*dp_graph(cand, lfs, 3)),
                             sample_evidence=False, device=DEVICE)
    t = eng.tables
    seed, burn, epochs = 5, 2, 10
    live = live_steps(t)

    def skipped():
        return metrics.snapshot()["counters"].get("sweep.skipped_steps", 0)

    pig.KERNEL_LAUNCHES = 0
    s0 = skipped()
    xk, ck = eng.run(seed, burn, epochs)
    torch.cuda.synchronize()
    launches, skips = pig.KERNEL_LAUNCHES, skipped() - s0
    xp, cp = eng.run(seed, burn, epochs, plain=True)
    torch.cuda.synchronize()
    same = torch.equal(xk, xp) and torch.equal(ck, cp)
    err = max(int((xk - xp).abs().max()), int((ck - cp).abs().max()))
    log("  dp %dx%d sample_evidence off: steps %d, rows %s, to update %s; "
        "%d + %d epochs: %d launches, %d steps skipped; kernel route == "
        "plain (values, tallies) %s, max |diff| %d"
        % (cand, lfs, t.n_steps, t.n_rows, t.n_update, burn, epochs,
           launches, skips, same, err))
    if live != 1 or launches != burn + epochs or \
            skips != (t.n_steps - live) * (burn + epochs):
        fail("dead steps: %d live steps, %d launches, %d skipped; "
             "expected 1 live step launched once an epoch"
             % (live, launches, skips))
    if not same:
        fail("dead steps: the kernel route differs from the plain version")
    return err


CAT_STARS = (127, 128, 129, 300)   # leaves of the categorical edge stars
CAT_STAR_CODES = ("EQUAL", "AND_CAT", "IMPLY_NATURAL_CAT", "LINEAR",
                  "DP_GEN_DEP_SIMILAR", "EQUAL_CAT_CONST")


def _cat_star(card, leaves, seed):
    """(weights, variables, factors, fmap) of a star at cardinality
    ``card``: variable 0 in one factor of arity 2 with each leaf, codes
    CAT_STAR_CODES in turn, 4 dyadic weights (one fixed), 30 %
    evidence; the centre is dataType 1 (its items sparse: d1, d2) when
    ``leaves`` is 300, a third of the leaves are. Two steps: the centre
    alone (a row of ``leaves`` items, longer than a chunk at KMAX 32 and
    128, and at 129 and 300 at KMAX 8) and ``leaves`` one-item rows."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    n = leaves + 1
    v = T.new_variables(n)
    v["cardinality"] = card
    v["dataType"] = rng.random(n) < 1 / 3
    v["dataType"][0] = leaves == 300
    v["isEvidence"] = rng.random(n) < 0.3
    v["initialValue"] = rng.integers(0, card, n)
    w = T.new_weights(4)
    w["initialValue"] = rng.choice(DYADIC, 4)
    w["isFixed"] = (True, False, False, False)
    f = T.new_factors(leaves)
    f["factorFunction"] = [T.FACTORS[CAT_STAR_CODES[i % len(CAT_STAR_CODES)]]
                           for i in range(leaves)]
    f["weightId"] = rng.integers(0, 4, leaves)
    f["featureValue"] = 1.0
    f["arity"] = 2
    f["ftv_offset"] = 2 * np.arange(leaves)
    fm = T.new_fmap(2 * leaves)
    fm["vid"][0::2] = 0
    fm["vid"][1::2] = np.arange(1, n)
    fm["dense_equal_to"] = rng.integers(0, card, 2 * leaves)
    return w, v, f, fm


def phase_cat_edges(torch):
    """Phase 2, the categorical kernels' edges (sweep_cat_kernel and
    learn_cat_kernel at KMAX 8, 32 and 128, cardinality 8, 32, 128), each
    against its plain version bit for bit: the stars of CAT_STARS (steps
    of 1, 127, 128, 129 and 300 rows, the centre's row longer than a
    chunk) under every map and draw, and learning (L2) on them; the
    has_ext forms (ext tables of dyadic values) on the star of 129;
    graph-sharded runs at 2 shards (the `send` packs) and learning on
    Potts 48x48 with 30 % evidence; and a conflicting step (Potts 16x16
    compiled with max_colors=1). Returns the largest difference."""
    import numpy as np

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import potts_grid
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops import itemgrid_mc as mc
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    log("== phase 2: the categorical kernels' edges (bit-equal)")
    t0 = time.perf_counter()
    worst = 0.0
    l2 = LearnParams(regularization=2, reg_param=0.01)
    for card in (8, 32, 128):
        for leaves in CAT_STARS:
            cg = compile_graph(*_cat_star(card, leaves, card + leaves))
            tables = None
            for label, sched in _every_map_and_draw(pig.default_schedule(cg)):
                eng = pig.ItemGridEngine(cg, device=DEVICE, schedule=sched)
                tables = tables or eng.tables
                worst = max(worst, check_equal(
                    torch, "star%d_card%d" % (leaves, card), label, eng,
                    burn=1, epochs=2))
            if sorted(tables.n_rows) != [1, leaves]:
                fail("star %d: steps of %s rows" % (leaves, tables.n_rows))
            eng = pig.ItemGridEngine(cg, device=DEVICE)
            worst = max(worst, check_learn_equal(
                torch, "star%d_card%d" % (leaves, card), eng, l2, burn=1,
                epochs=2))
            if leaves != 129:
                continue
            rng = np.random.default_rng(card)
            ext = [torch.as_tensor(rng.choice(DYADIC, (cg.n_vars, card + 3)),
                                   dtype=torch.float32, device=DEVICE)
                   for _ in range(2)]
            for what, fn in (
                    ("run", lambda plain: eng.run(3, 1, 3, ext_pot=ext[0],
                                                  plain=plain)),
                    ("learn", lambda plain: eng.learn(
                        3, 1, 2, 0.05, 0.98, l2, ext_pot=ext[0],
                        ext_pot_evid=ext[1], plain=plain))):
                got, want = fn(False), fn(True)
                same = all(_bits_equal(torch, a, b)
                           for a, b in zip(got, want))
                log("  star129_card%d ext %-5s kernel == plain: %s"
                    % (card, what, same))
                if not same:
                    fail("has_ext %s on the card-%d star disagrees with "
                         "the plain version" % (what, card))
    for card in (20, 128):
        w, v, f, fm, dm, _ = _with_evidence(potts_grid(
            48, 48, card=card, weight=0.25, fixed=False), 0.3, card)
        cg = compile_graph(w, v, f, fm, domain_mask=dm)
        eng = mc.MultiChipItemGridEngine(cg, n_shards=2, device=DEVICE)
        for what, fn in (("run", lambda plain: eng.run(5, 1, 3,
                                                       plain=plain)),
                         ("learn", lambda plain: eng.learn(
                             9, 1, 2, 0.05, 0.98, l2, plain=plain))):
            got, want = fn(False), fn(True)
            same = all(_bits_equal(torch, a, b) for a, b in zip(got, want))
            log("  potts48_card%d 2 shards (send) %-5s kernel == plain: %s"
                % (card, what, same))
            if not same:
                fail("sharded %s on the card-%d Potts grid disagrees with "
                     "the plain version" % (what, card))
        w, v, f, fm, dm, _ = _with_evidence(potts_grid(
            16, 16, card=card, weight=0.25, fixed=False), 0.3, card + 1)
        eng = pig.ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm,
                                               max_colors=1), device=DEVICE)
        if eng.tables.conflict != [True]:
            fail("max_colors=1 Potts: the one color is not conflicting")
        worst = max(worst, check_equal(torch, "potts16_card%d_max_colors1"
                                       % card, "own", eng, burn=1, epochs=3),
                    check_learn_equal(torch, "potts16_card%d_max_colors1"
                                      % card, eng, l2, burn=1, epochs=2))
    log("  the categorical edges took %.1f s" % (time.perf_counter() - t0))
    return worst


KEPT_DP = (20000, 24)    # phase 2's kept-form DP graph: the EHR shape
KEPT_MIXED = (300, 600, 2, 70)  # left rows, right rows, degree, wide degree


def _kept_mixed(card, seed):
    """(weights, variables, factors, fmap) of a bipartite graph at
    cardinality ``card`` whose left rows fall in tiles of both forms of
    the categorical learn kernel: KEPT_MIXED's left variables each in
    arity-2 factors (CAT_STAR_CODES in turn, 4 dyadic weights, one fixed)
    with ``degree`` random right variables, except left rows 200 and 201
    with ``wide`` (more evaluations than a warp keeps, so their tile takes
    the re-read form while the left step's other tiles are kept); a third
    of the variables dataType 1 (sparse items), 30 % evidence."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    n_l, n_r, degree, wide = KEPT_MIXED
    rng = np.random.default_rng(seed)
    deg = np.full(n_l, degree)
    deg[200:202] = wide
    n, m = n_l + n_r, int(deg.sum())
    v = T.new_variables(n)
    v["cardinality"] = card
    v["dataType"] = rng.random(n) < 1 / 3
    v["isEvidence"] = rng.random(n) < 0.3
    v["initialValue"] = rng.integers(0, card, n)
    w = T.new_weights(4)
    w["initialValue"] = rng.choice(DYADIC, 4)
    w["isFixed"] = (True, False, False, False)
    f = T.new_factors(m)
    f["factorFunction"] = [T.FACTORS[CAT_STAR_CODES[i % len(CAT_STAR_CODES)]]
                           for i in range(m)]
    f["weightId"] = rng.integers(0, 4, m)
    f["featureValue"] = 1.0
    f["arity"] = 2
    f["ftv_offset"] = 2 * np.arange(m)
    fm = T.new_fmap(2 * m)
    fm["vid"][0::2] = np.repeat(np.arange(n_l), deg)
    fm["vid"][1::2] = n_l + np.concatenate(
        [rng.choice(n_r, d, replace=False) for d in deg])
    fm["dense_equal_to"] = rng.integers(0, card, 2 * m)
    return w, v, f, fm


def phase_kept_form(torch):
    """Phase 2, the categorical learn kernel's two forms, each held bit
    for bit against the plain version (weights and both chains after
    every learn step): (a) ``dp_graph`` at the EHR shape (KEPT_DP: 24
    LFs), every step in the kept form, under L2 with learn_non_evidence
    (the benchmark's setting) and under the default parameters; (b) the
    bipartite graphs of ``_kept_mixed`` at cardinality 8, 32 and 40 (the
    KMAX 8, 32 and 128 kernels; a card-128 row is too wide to keep), a
    step of which has tiles of both forms (a launch of each kernel);
    then the forms the entry refuses (``check_form_refusals``). Returns
    the largest difference."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    log("== phase 2: the categorical learn kernel's kept and re-read forms "
        "(bit-equal)")
    t0 = time.perf_counter()
    worst = 0.0
    cand, lfs = KEPT_DP
    eng = pig.ItemGridEngine(compile_graph(*dp_graph(cand, lfs, 3)),
                             device=DEVICE)
    lt = eng.learn_tables()
    items = [len(i) for i in lt.sweep.item_index]
    kept = _kept_items(lt)
    log("  dp%d_lf%d: kept items %s of %s a step" % (
        cand, lfs, kept, items))
    if kept != items or eng.cg.kmax != 3:
        fail("the EHR-shape DP graph is not in the kept form in every step")
    for label, lp in (("l2_non_evidence", LearnParams(
            regularization=2, reg_param=0.1, learn_non_evidence=True)),
                      ("default", LearnParams())):
        worst = max(worst, check_learn_equal(
            torch, "dp%d_lf%d_%s" % (cand, lfs, label), eng, lp, burn=1,
            epochs=3))
    l2 = LearnParams(regularization=2, reg_param=0.01)
    for card in (8, 32, 40):
        w, v, f, fm = _kept_mixed(card, card)
        eng = pig.ItemGridEngine(compile_graph(w, v, f, fm), device=DEVICE)
        lt = eng.learn_tables()
        items = [len(i) for i in lt.sweep.item_index]
        kept = _kept_items(lt)
        log("  kept_mixed_card%d: kept items %s of %s a step, tiles %s"
            % (card, kept, items, lt.n_tiles))
        if not any(0 < k < n for k, n in zip(kept, items)):
            fail("kept_mixed_card%d: no step has tiles of both forms" % card)
        worst = max(worst, check_learn_equal(
            torch, "kept_mixed_card%d" % card, eng, l2, burn=1, epochs=3))
        worst = max(worst, check_learn_equal(
            torch, "kept_mixed_card%d_non_ev" % card, eng, LearnParams(
                regularization=1, reg_param=0.01, truncation=4,
                learn_non_evidence=True), burn=1, epochs=3))
    check_form_refusals(torch)
    log("  the two forms took %.1f s" % (time.perf_counter() - t0))
    return worst


def check_form_refusals(torch):
    """The learn entry launches only a form the tables can give: tables
    whose recorded launches are rewritten to `item` at KMAX 8
    (``_kept_mixed``), to `item` on the hub graph's step whose
    HUB_FACTORS-item row passes kItemTile, and to `kept` at KMAX 2 are
    each refused with CUDA error 1 (cudaErrorInvalidValue) before any
    launch, and the card goes on working."""
    import dataclasses

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]
    hub = random_graph(("EQUAL",), "hub", 1)
    for name, graph, form in (("kept_mixed_card8", _kept_mixed(8, 8), "item"),
                              ("hub", hub, "item"), ("hub", hub, "kept")):
        eng = pig.ItemGridEngine(compile_graph(*graph), device=DEVICE)
        lt = eng.learn_tables()
        ci = max(range(lt.sweep.n_steps), key=lambda c: lt.smem_items[c])
        code = pig.LEARN_FORMS.index(form)
        bad = dataclasses.replace(lt, launches=[
            [r._replace(form=code) for r in rs] for rs in lt.launches])
        x = torch.as_tensor(eng.cg.var_init, dtype=torch.int32,
                            device=DEVICE)
        w = torch.as_tensor(eng.cg.weight_init, dtype=torch.float32,
                            device=DEVICE)
        launches = pig.LEARN_LAUNCHES
        try:
            pig.learn_color(bad, ci, x, x.clone(), w, 1, pig.LEARN_EPOCH0,
                            hs)
        except RuntimeError as e:
            if "CUDA error 1" not in str(e) or \
                    pig.LEARN_LAUNCHES != launches:
                fail("%s as %s: %s" % (name, form, e))
            log("  %s step %d (kmax %d, longest piece %d) as %s: refused, "
                "%s" % (name, ci, lt.sweep.kmax, lt.smem_items[ci], form, e))
        else:
            fail("%s as %s was launched" % (name, form))
    torch.cuda.synchronize()


def _ising_one_color():
    """Ising 64x64 with 30 % evidence and a learnable weight, compiled
    with max_colors=1: every row reads neighbours of its own color."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_grid
    w, v, f, fm, dm, _ = _with_evidence(ising_grid(64, 64, weight=0.25,
                                                   fixed=False), 0.3, 2)
    return compile_graph(w, v, f, fm, domain_mask=dm, max_colors=1)


def _with_evidence(model, frac, seed, values=None):
    """``model`` with a random ``frac`` of its variables made evidence
    (values from ``values``, or random below each cardinality)."""
    import numpy as np
    w, v, f, fm, dm, e = model
    rng = np.random.default_rng(seed)
    v["isEvidence"] = (rng.random(len(v)) < frac).astype(np.int8)
    v["initialValue"] = values if values is not None else \
        rng.integers(0, 1 << 30, len(v)) % v["cardinality"]
    return w, v, f, fm, dm, e


def _learn_fixtures():
    """(name, graph, LearnParams): every learn kernel template (kmax 2,
    8, 32, 128), L1 and L2, mean and sum, learn_non_evidence, fixed
    weights, arity 51, 4096 weights, and a conflicting color."""
    import numpy as np

    from numbskull_tpu_torch import models as M
    from numbskull_tpu_torch import types as T
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops.gibbs import LearnParams

    def cg(t, **kw):
        w, v, f, fm, dm, _ = t
        return compile_graph(w, v, f, fm, domain_mask=dm, **kw)

    l2 = LearnParams(regularization=2, reg_param=1e-4)
    out = [("coin", cg(M.coin_model(4096, *COIN_TRUTH, evidence=True,
                                     fixed=False, seed=3)), l2)]
    out.append(("ising64_ev30_sum", cg(_with_evidence(M.ising_grid(
        64, 64, weight=0.25, fixed=False), 0.3, 1)),
        LearnParams(regularization=0, grad_agg="sum")))
    t = M.lf_model(0.5, [0.5, 0.25, 0.75], copies=2000, seed=1)
    t[0]["isFixed"][2] = True
    out.append(("lf_card3_l1", cg(t), LearnParams(
        regularization=1, reg_param=0.01, truncation=4,
        learn_non_evidence=True)))
    for card in (64, 128):
        r, c = np.divmod(np.arange(32 * 32), 32)
        t = _with_evidence(M.potts_grid(32, 32, card=card, weight=0.0,
                                        fixed=False), 0.3, card,
                           ((r // 4) * 3 + c // 4) % card)
        out.append(("potts32_card%d_ev30" % card,
                    cg(t, color_hint=M.ising_color_hint(32, 32)), l2))
    out.append(("voting_degree50_ev30", cg(M.voting_grouped(
        10000, 50, weight=0.5, fixed=False, evidence_frac=0.3)), l2))
    n = 4096
    v = T.new_variables(n)
    v["isEvidence"] = 1
    v["initialValue"] = np.random.default_rng(9).integers(0, 2, n)
    v["cardinality"] = 2
    w = T.new_weights(n)
    f = T.new_factors(n)
    f["factorFunction"] = T.FUNC_ISTRUE
    f["weightId"] = np.arange(n)
    f["featureValue"] = 1.0
    f["arity"] = 1
    f["ftv_offset"] = np.arange(n)
    fm = T.new_fmap(n)
    fm["vid"] = np.arange(n)
    out.append(("istrue4096_l1", compile_graph(w, v, f, fm), LearnParams(
        regularization=1, reg_param=0.01, truncation=3)))
    out.append(("ising64_max_colors1", _ising_one_color(), l2))
    # one row of 5000 items, beyond a tile's item budget (summed in
    # pieces), two weights, non-dyadic featureValues
    n = 5000
    rng = np.random.default_rng(11)
    v = T.new_variables(n + 1)
    v["isEvidence"] = (rng.random(n + 1) < 0.3).astype(np.int8)
    v["initialValue"] = rng.integers(0, 2, n + 1)
    v["cardinality"] = 2
    w = T.new_weights(2)
    w["isFixed"] = False
    f = T.new_factors(n)
    f["factorFunction"] = T.FUNC_EQUAL
    f["weightId"] = np.arange(n) % 2
    f["featureValue"] = rng.uniform(0.3, 1.7, n)
    f["arity"] = 2
    f["ftv_offset"] = 2 * np.arange(n)
    fm = T.new_fmap(2 * n)
    fm["vid"][0::2] = 0
    fm["vid"][1::2] = np.arange(1, n + 1)
    out.append(("star5000_oversized_row", compile_graph(w, v, f, fm), l2))
    return out


def _kept_items(lt) -> list:
    """Per step of learn tables ``lt``: the items of its launch in the
    kept form (LearnTables.launches), 0 where it has none."""
    from numbskull_tpu_torch.ops.itemgrid import LEARN_FORMS
    return [sum(r.items for r in rs if LEARN_FORMS[r.form] == "kept")
            for rs in lt.launches]


def live_steps(t) -> int:
    """Sweep launches of one epoch on tables ``t`` without a pack buffer:
    one per step with a row to update (``ops/itemgrid.sweep_color``
    skips the others)."""
    return sum(1 for n in t.n_update if n > 0)


def learn_launches_per_epoch(lt) -> int:
    """Learn kernel launches of one epoch on these tables: per color with
    rows, the step kernel once per form its tiles take (the recorded
    launches), and the sum kernel when it has items."""
    return sum(len(lt.launches[ci]) + (lt.n_wt[ci] > 0)
               for ci in range(lt.sweep.n_steps) if lt.sweep.n_rows[ci] > 0)


def _bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_learn(torch, eng, lp, seed=7, burn=2, epochs=5, stepsize=0.05,
                  decay=0.98):
    """Lockstep learn kernels vs plain version from one state on the
    card, over the engine's own learn tables: the burn-in through both
    sweep versions, then every (epoch, color) through both learn
    versions, comparing weights and both chains after each. Returns
    (equal steps, steps, max abs difference, kernel weights)."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    cg, dev = eng.cg, eng.device
    lt = eng.learn_tables()
    t = lt.sweep
    wk = torch.tensor(cg.weight_init, dtype=torch.float32, device=dev)
    xk = torch.tensor(cg.var_init, dtype=torch.int32, device=dev)
    wp, xp, xek, xep = wk.clone(), xk.clone(), xk.clone(), xk.clone()
    counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                         device=dev)
    for b in range(burn):
        for ci in range(t.n_steps):
            pig.sweep_color(t, ci, xk, counts, wk, seed, b, False,
                            pig.BURN_SALT_XOR)
            pig.color_step_reference(t, ci, xp, counts, wp, seed, b, False,
                                     pig.BURN_SALT_XOR)
    equal = total = 0
    for i, hs in enumerate(pig.learn_steps(lp, stepsize, decay, epochs)):
        for ci in range(t.n_steps):
            pig.learn_color(lt, ci, xk, xek, wk, seed,
                            i + pig.LEARN_EPOCH0, hs)
            pig.learn_color_step_reference(lt, ci, xp, xep, wp, seed,
                                           i + pig.LEARN_EPOCH0, hs)
            equal += int(_bits_equal(torch, wk, wp) and
                         _bits_equal(torch, xk, xp) and
                         _bits_equal(torch, xek, xep))
            total += 1
    torch.cuda.synchronize()
    err = max(float((wk - wp).abs().max()) if len(wk) else 0.0,
              float((xk - xp).abs().max()), float((xek - xep).abs().max()))
    return equal, total, err, wk


def check_learn_equal(torch, name, eng, lp, moves=True, **kw):
    """compare_learn(), logged; fails on any unequal step, or when the
    weights did not move (``moves``) or did (not ``moves``: a graph of
    NOOP items alone, which no weight step counts). Returns the max abs
    difference (0)."""
    eq, tot, err, w = compare_learn(torch, eng, lp, **kw)
    w0 = torch.as_tensor(eng.cg.weight_init, dtype=torch.float32,
                         device=w.device)
    moved = int((w != w0).sum())
    log("  %-22s kmax %3d colors %2d weights %4d (%d moved): %d of %d "
        "learn steps equal, max |diff| %g" % (
            name, eng.cg.kmax, eng.cg.n_colors, eng.cg.n_weights, moved, eq,
            tot, err))
    if eq != tot or err != 0:
        fail("learn kernels and plain version disagree on %s" % name)
    if (moved == 0) == moves:
        fail("%s weight moved on %s" % ("no" if moves else "a", name))
    return err


def phase_learn_compare(torch):
    """Phase 2, learning; returns the largest kernel-vs-plain
    difference seen."""
    import numpy as np

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import coin_model, lf_model
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    log("== phase 2: learn kernels vs plain version on the card "
        "(bit-equal)")
    worst = 0.0
    for name, cg, lp in _learn_fixtures():
        eng = pig.ItemGridEngine(cg, device=DEVICE)
        worst = max(worst, check_learn_equal(torch, name, eng, lp))

    # two kernel runs from one seed with non-dyadic featureValues (sums
    # that round): the LF graph (KMAX 8) and the coin graph (KMAX 2, the
    # items kept in registers)
    lp = LearnParams(regularization=2, reg_param=0.01,
                     learn_non_evidence=True)
    rng = np.random.default_rng(5)
    for name, model in (
            ("lf", lf_model(0.5, [0.9, 0.6, 0.3, 0.8], copies=5000, seed=4)),
            ("coin", coin_model(20000, *COIN_TRUTH, evidence=True,
                                fixed=False, seed=6))):
        w, v, f, fm, dm, _ = model
        f["featureValue"] = rng.uniform(0.3, 1.7, len(f))
        eng = pig.ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                                 device=DEVICE)
        runs = [eng.learn(3, 2, 20, 0.05, 0.98, lp) for _ in range(2)]
        same = all(_bits_equal(torch, a, b) for a, b in zip(*runs))
        _, _, err, _ = compare_learn(torch, eng, lp)
        log("  %s non-dyadic featureValues: two kernel runs of 20 epochs "
            "%s; weights %s; lockstep against the plain version max |diff| "
            "%g" % (name, "bit-identical" if same else "DIFFER",
                    np.array2string(runs[0][0].cpu().numpy(), precision=6),
                    err))
        if not same or err != 0:
            fail("learn kernels are not deterministic or differ from the "
                 "plain version (non-dyadic %s)" % name)
    return worst


def phase_main_path(torch, workdir):
    """Phase 3; returns (kernel launches, NumbSkull, max kernel-vs-plain
    difference on the main path's own tables)."""
    import numpy as np

    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.models import ising_grid
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    log("== phase 3: CLI main path (inference), %dx%d Ising on the card"
        % (GRID, GRID))
    t0 = time.perf_counter()
    w, v, f, fm, _, _ = ising_grid(GRID, GRID, weight=0.25)
    gdir = os.path.join(workdir, "ising1024")
    dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    log("  wrote %d variables, %d factors in %.2f s"
        % (len(v), len(f), time.perf_counter() - t0))
    out = os.path.join(workdir, "out")
    burn, epochs = 50, 500
    metrics.reset()
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    t0 = time.perf_counter()
    ns = cli.main([gdir, "-i", str(epochs), "-b", str(burn), "-o", out,
                   "-q", "--device", DEVICE, "--engine", "hbm"])
    wall = time.perf_counter() - t0
    launches = pig.KERNEL_LAUNCHES
    if metrics.snapshot()["counters"].get("engine.requested.hbm") != 1:
        fail("--engine hbm was not recorded as the engine asked for")
    fg = ns.factorGraphs[0]
    eng = fg.engine(ns.sample_evidence)
    n_colors = live_steps(eng.tables)
    log("  main() took %.2f s (load + compile + %d epochs + dump); "
        "inference %.3f s; %d launches, %d colors"
        % (wall, burn + epochs, fg.inference_total_time, launches,
           n_colors))
    tm = metrics.snapshot()["timings"]
    log("  breakdown (s): " + ", ".join(
        "%s %.3f" % (k, tm[k]["total_s"]) for k in (
            "load.files_s", "compile", "state_init", "itemgrid.build",
            "inference.sweep_s", "dump.marginals_s")))
    if launches != (burn + epochs) * n_colors:
        fail("kernel launches %d != (%d + %d) x %d colors"
             % (launches, epochs, burn, n_colors))
    if pig.LEARN_LAUNCHES != 0:
        fail("-l 0 launched the learn kernels")
    text = os.path.join(out, "inference_result.out.text")
    weights = os.path.join(out, "inference_result.out.weights.text")
    for p in (text, weights):
        if not os.path.isfile(p):
            fail("missing output " + p)
    rows = np.loadtxt(text, dtype=np.float64, ndmin=2)
    if rows.shape != (GRID * GRID, 3):
        fail("inference_result.out.text has shape %s" % (rows.shape,))
    prob = rows[:, 2]
    if not np.isfinite(prob).all() or (prob < 0).any() or (prob > 1).any():
        fail("marginals outside [0, 1]")
    mean = float(prob.mean())
    log("  %d marginal rows, mean marginal %.4f" % (len(rows), mean))
    if not 0.4 < mean < 0.6:
        fail("mean marginal %.4f outside (0.4, 0.6)" % mean)
    err = check_equal(torch, "ising1024 (CLI tables)", "own", eng,
                      burn=2, epochs=3)
    by_kernel = {}
    device_busy(torch, lambda: eng.run(1, 0, 20), by_kernel)
    log_sweep("ising1024 (CLI tables), 20 epochs", by_kernel)
    return launches, ns, err


def phase_learn_main_path(torch, workdir):
    """Phase 4; returns (learn launches, NumbSkull, max kernel-vs-plain
    difference on the main path's own learn tables)."""
    import numpy as np

    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.models import coin_model
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    log("== phase 4: CLI main path (learning), coin %d copies on the card"
        % COIN_COPIES)
    t0 = time.perf_counter()
    w, v, f, fm, _, _ = coin_model(COIN_COPIES, *COIN_TRUTH, evidence=True,
                                   fixed=False, seed=3)
    gdir = os.path.join(workdir, "coin")
    dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    log("  wrote %d variables, %d factors in %.2f s"
        % (len(v), len(f), time.perf_counter() - t0))
    out = os.path.join(workdir, "out_learn")
    lrn, burn, epochs = 150, 10, 100
    metrics.reset()
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    t0 = time.perf_counter()
    ns = cli.main([gdir, "-l", str(lrn), "-i", str(epochs), "-b", str(burn),
                   "-s", "0.1", "-d", "0.99", "-r", "1e-4", "-o", out, "-q",
                   "--device", DEVICE])
    wall = time.perf_counter() - t0
    sweeps, learns = pig.KERNEL_LAUNCHES, pig.LEARN_LAUNCHES
    fg = ns.factorGraphs[0]
    eng = fg.engine(True)
    lt = eng.learn_tables()
    n_colors = live_steps(eng.tables)
    per_epoch = learn_launches_per_epoch(lt)
    log("  main() took %.2f s; learning %.3f s, inference %.3f s; %d learn "
        "launches (%d per epoch), %d sweep launches, %d colors"
        % (wall, fg.learning_total_time, fg.inference_total_time, learns,
           per_epoch, sweeps, n_colors))
    tm = metrics.snapshot()["timings"]
    log("  breakdown (s): " + ", ".join(
        "%s %.3f" % (k, tm[k]["total_s"]) for k in (
            "load.files_s", "compile", "state_init", "itemgrid.build",
            "itemgrid.learn_tables", "learning.sweep_s", "inference.sweep_s",
            "dump.weights_s", "dump.marginals_s")))
    if learns != lrn * per_epoch:
        fail("learn launches %d != %d epochs x %d" % (learns, lrn,
                                                      per_epoch))
    if sweeps != (burn + burn + epochs) * n_colors:
        fail("sweep launches %d != (%d burn-in of learning + %d + %d) x %d "
             "colors" % (sweeps, burn, burn, epochs, n_colors))
    path = os.path.join(out, "inference_result.out.weights.text")
    if not os.path.isfile(path):
        fail("missing output " + path)
    got = np.loadtxt(path, ndmin=2)[:, 1]
    off = np.abs(got - np.asarray(COIN_TRUTH)).max()
    log("  learned weights %s (truth %s), max |off| %.4f"
        % (np.array2string(got, precision=4), COIN_TRUTH, off))
    if got.shape != (3,) or not off < 0.15:
        fail("learned coin weights off the truth by more than 0.15")
    rows = np.loadtxt(os.path.join(out, "inference_result.out.text"),
                      ndmin=2)
    if rows.shape != (2 * COIN_COPIES, 3) or \
            not np.isfinite(rows[:, 2]).all():
        fail("inference_result.out.text after learning has shape %s"
             % (rows.shape,))
    err = check_learn_equal(torch, "coin400k (CLI tables)", eng,
                            LearnParams(regularization=2, reg_param=1e-4),
                            burn=2, epochs=3, stepsize=0.1, decay=0.99)
    return learns, ns, err


def _time_epochs(torch, fn, epochs):
    """CUDA-event time (ms) of fn(epochs)."""
    from numbskull_tpu_torch.benchutil import call_ms
    return call_ms(lambda: fn(epochs), DEVICE)


def _plain_run(torch, eng, seed, epochs):
    """ItemGridEngine.run through color_step_reference (the plain
    version) on the card."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    cg, dev = eng.cg, eng.device
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32, device=dev)
    x = torch.tensor(cg.var_init, dtype=torch.int32, device=dev)
    counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                         device=dev)
    s977 = pig.seed977_of(seed)
    for epoch in range(epochs):
        for ci in range(eng.tables.n_steps):
            pig.color_step_reference(eng.tables, ci, x, counts, w, s977,
                                     epoch, True)
    return x, counts


def _plain_learn(torch, eng, lp, seed, epochs):
    """ItemGridEngine.learn (no burn-in) through
    learn_color_step_reference on the card."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    cg, dev = eng.cg, eng.device
    lt = eng.learn_tables()
    w = torch.tensor(cg.weight_init, dtype=torch.float32, device=dev)
    x = torch.tensor(cg.var_init, dtype=torch.int32, device=dev)
    xe = x.clone()
    for i, hs in enumerate(pig.learn_steps(lp, 0.1, 0.99, epochs)):
        for ci in range(lt.sweep.n_steps):
            pig.learn_color_step_reference(lt, ci, x, xe, w, seed,
                                           i + pig.LEARN_EPOCH0, hs)
    return w


def epoch_rate(torch, fn, n_updates, lo, hi, tries=2, warm=True):
    """Epoch-differenced updates per second and ms per epoch of
    ``fn(epochs)``, best of ``tries`` per point, after one warm-up epoch
    when ``warm``."""
    if warm:
        fn(1)
    t_lo = min(_time_epochs(torch, fn, lo) for _ in range(tries))
    t_hi = min(_time_epochs(torch, fn, hi) for _ in range(tries))
    per_ms = (t_hi - t_lo) / (hi - lo)
    return n_updates / (per_ms / 1e3), per_ms


def rate(torch, eng, plain, lo, hi, lp=None):
    """Epoch-differenced variable updates per second and ms per epoch of
    inference, or of learning when ``lp`` is given."""
    if lp is not None:
        fn = (lambda e: _plain_learn(torch, eng, lp, 1, e)) if plain else \
            (lambda e: eng.learn(1, 0, e, 0.1, 0.99, lp))
    elif plain:
        def fn(e):
            _plain_run(torch, eng, 1, e)
    else:
        def fn(e):
            eng.run(1, 0, e)
    return epoch_rate(torch, fn, eng.cg.n_vars, lo, hi)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops`` float32 operations."""
    from numbskull_tpu_torch.experiments.common import bound_ms
    return bound_ms(nbytes, ops)


def _gathered(torch, t, ci):
    """Distinct variables that step ci's items read from the chains."""
    lo = t.item0[ci]
    hi = lo + len(t.item_index[ci])
    if hi == lo:
        return 0
    vid = t.arg_vid[int(t.it_arg[lo]):int(t.it_arg[hi])]
    return int(torch.unique(vid[vid >= 0]).numel())


def sweep_epoch_cost(torch, t):
    """(bytes, operations) of one inference epoch through the sweep
    kernel, from this graph's tables: each step reads its rows (17 B),
    items (12 B packed; 25 B unpacked) and arguments (8 B packed; 13 B
    unpacked) once, the values it gathers once (4 B each) and the
    weights once, and writes its rows' values (4 B) and tallies (one
    int32 read and written); operations count each item's evaluation at
    each candidate (6 per argument + 12) and each row's draw (6 per
    candidate + 30, the hash included)."""
    K = t.kmax
    rows = sum(t.n_rows)
    items, args = int(t.it_wid.numel()), int(t.arg_vid.numel())
    nbytes = rows * (17 + 4 + 8) + items * 12 + args * 8 + 4 * t.n_weights
    nbytes += 4 * sum(_gathered(torch, t, ci) for ci in range(t.n_steps))
    ops = K * (6 * args + 12 * items) + rows * (6 * K + 30)
    return nbytes, ops


def learn_epoch_cost(torch, lt):
    """(bytes, operations) of one learning epoch, the work's own: each
    step reads its rows (17 B), items (12 B packed; 25 B unpacked) and
    their featureValues (4 B) and arguments (8 B packed; 13 B unpacked)
    once, gathers both chains' values once
    (8 B per distinct variable read) and writes both chains' rows (8 B),
    and the weights are read (with their fixed flags) and written once
    (9 B). No order table of a design is charged. Operations: both
    chains' potentials and draws, and two more evaluations and a sum per
    item."""
    t = lt.sweep
    K = t.kmax
    rows = sum(t.n_rows)
    items, args = int(t.it_wid.numel()), int(t.arg_vid.numel())
    nbytes = rows * (17 + 8) + items * (12 + 4) + args * 8
    nbytes += 8 * sum(_gathered(torch, t, ci) for ci in range(t.n_steps))
    nbytes += 9 * t.n_weights
    ops = 2 * (K * (6 * args + 12 * items) + rows * (6 * K + 30))
    ops += 2 * (6 * args + 12 * items) + 2 * items
    return nbytes, ops


def lattice_bound(n, sweeps):
    """(ms, "bytes" or "operations", pipe) of one sweep of an n x n
    lattice in a call of ``sweeps`` sweeps (experiments/common: 12 B a
    cell a call, 14 integer operations per updated cell)."""
    from numbskull_tpu_torch.experiments.common import lattice_bound_ms
    return lattice_bound_ms(n, n, sweeps)


def device_busy(torch, fn, by_kernel=None):
    """Share of a window's wall time that the device spent in kernels and
    copies (torch.profiler), or None when the trace holds no device time.
    Only the trace's device rows count: an aten op's row repeats the
    device time of the kernels it launched. With ``by_kernel`` (a dict),
    also fills it with {name: (calls, device us)} of those rows; the
    trace may drop some calls, so a time per call is the reading."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        dev_us += us
        if by_kernel is not None:
            by_kernel[e.key] = (e.count, us)
    return dev_us / wall_us if dev_us > 0 else None


def device_rows_us(torch, fn, reps):
    """{name: device times (us)} of the device rows (kernels and copies)
    in a trace of ``reps`` calls of ``fn``, each list in trace order (the
    trace may drop a few rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and
                     e.self_device_time_total > 0),
                    key=lambda e: e.time_range.start):
        rows.setdefault(e.name, []).append(e.self_device_time_total)
    return rows


def median_call_ms(turns, reps):
    """Median device time (ms) of one call, from device_rows_us of turns
    of ``reps`` calls each: per kernel name, the median of its rows times
    the rows it runs per call (from the fullest turn: the trace drops
    some rows, which leaves a median unbiased), summed over the names.
    Fails with fewer than 20 rows of a name."""
    total = 0.0
    for name in set().union(*turns):
        rows = sum((t.get(name, []) for t in turns), [])
        if len(rows) < 20:
            fail("%s: %d device rows in %d calls" % (name, len(rows),
                                                      reps * len(turns)))
        per = max(1, round(max(len(t.get(name, ())) for t in turns) / reps))
        total += per * statistics.median(rows)
    return total / 1e3


def log_kernel_times(by_kernel):
    """Log each kernel's calls in the trace and device time per call."""
    for name, (calls, us) in sorted(by_kernel.items(),
                                    key=lambda kv: -kv[1][1]):
        log("    %-60.60s %5d calls, %.4f ms per call"
            % (name, calls, us / 1e3 / calls))


def phase_rates(torch, ising_ns, coin_ns, card):
    """Phase 5; returns {graph: {"kernel": (ups, ms), "plain": ...}} for
    inference and learning, and the max kernel-vs-plain difference of
    each on the LF graph. Without ``ising_ns`` (the `learn` mode) the
    Ising inference rates are left out."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import lf_model
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    log("== phase 5: epoch-differenced rates (CUDA events), " + card)
    t0 = time.perf_counter()
    w, v, f, fm, dm, _ = lf_model(0.7, [0.5, 0.25, 0.75, 0.5, 1.0],
                                  copies=LF_COPIES, seed=3)
    lf_eng = pig.ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                                device=DEVICE)
    log("  lf graph: %d variables, %d factors, %d colors, kmax %d "
        "(built in %.1f s)" % (len(v), len(f), lf_eng.cg.n_colors,
                               lf_eng.cg.kmax, time.perf_counter() - t0))
    lp_lf = LearnParams(regularization=1, reg_param=0.01, truncation=10,
                        learn_non_evidence=True)
    lp_coin = LearnParams(regularization=2, reg_param=1e-4)
    err_sweep = check_equal(torch, "lf200k", "own", lf_eng, burn=2,
                            epochs=3)
    err_learn = check_learn_equal(torch, "lf200k", lf_eng, lp_lf, burn=2,
                                  epochs=3)
    graphs = (
        ("ising1024", "infer", ising_ns and ising_ns.factorGraphs[0].engine(
            True), None, (20, 220), (2, 12)),
        ("lf200k", "infer", lf_eng, None, (20, 220), (2, 12)),
        ("coin400k", "learn", coin_ns.factorGraphs[0].engine(True), lp_coin,
         (20, 120), (2, 6)),
        ("lf200k", "learn", lf_eng, lp_lf, (20, 120), (2, 6)))
    result = {}
    for gname, what, eng, lp, kern_pts, plain_pts in graphs:
        if eng is None:               # `learn` mode: no phase 3 graph
            continue
        meas = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            pts = plain_pts if which == "plain" else kern_pts
            ups, ms = rate(torch, eng, which == "plain", *pts, lp=lp)
            meas.setdefault(which, []).append((ups, ms))
            log("  %-9s %-5s %-6s %.6g variable updates/s, %.4f ms/epoch "
                "(epochs %d..%d)" % (gname, what, which, ups, ms, *pts))
        result[(gname, what)] = {k: max(vs) for k, vs in meas.items()}
        by_kernel = {}
        busy = device_busy(torch, (lambda: eng.run(1, 0, 50)) if lp is None
                           else (lambda: eng.learn(1, 0, 50, 0.1, 0.99, lp)),
                           by_kernel)
        log("  %-9s %-5s kernel device busy share over 50 epochs: %s"
            % (gname, what, "not measured (no device time in the trace)"
               if busy is None else "%.3f" % busy))
        log_kernel_times(by_kernel)
        if lp is None:
            log_sweep(gname + ", 50 epochs", by_kernel)
    return result, err_sweep, err_learn


def compare_stencil(torch, n, m, weight, bias, burn, epochs, seed=7):
    """Kernel vs plain version of grid_gibbs from one lattice on the card.
    Returns (equal cells, cells, max abs difference of x and count)."""
    from numbskull_tpu_torch.ops import stencil_kernel as sk
    x0 = sk.initial_lattice(seed, n, m, DEVICE)
    kw = dict(n=n, m=m, weight=weight, bias=bias)
    xk, ck = sk.grid_gibbs(x0, seed, burn, epochs, **kw)
    xp, cp = sk.grid_gibbs_reference(x0, seed, burn, epochs, **kw)
    torch.cuda.synchronize()
    equal = int(((xk == xp) & (ck == cp)).sum())
    err = max(int((xk - xp).abs().max()), int((ck - cp).abs().max()))
    return equal, n * m, err


def stencil_edge_fixtures():
    """Fixtures at the edges of each tile and k of the plan's table
    (ops/stencil_kernel._PLANS): sides of T - 1, T, T + 1 and 2T + 1
    (columns widened by whole tiles until the lattice reaches the row of
    the table), and burn k - 1, k and k + 1 with k + 1 epochs, so chunks
    start and end inside the burn-in and the first tallied chunk stores
    its counts."""
    from numbskull_tpu_torch.ops import stencil_kernel as sk
    out = []
    for floor, tr, tc, k, _, _ in sk._PLANS:
        shapes = ((tr - 1, tc + 1, 1, k + 2), (tr, tc, 1, k + 2),
                  (2 * tr + 1, 2 * tc + 1, 1, k + 2),
                  *((tr + 1, tc - 1, burn, k + 1)
                    for burn in (k - 1, k, k + 1)))
        for n, m, burn, epochs in shapes:
            m += tc * max(0, -(-(floor - n * m) // (n * tc)))
            out.append((n, m, 0.4, 0.1, burn, epochs))
    return tuple(out)


def phase_stencil_compare(torch):
    """Phase 2, lattice: kernel #8 against its plain version, bit for bit,
    on the fixtures, the plan's tile and chunk edges, and at the lattice
    phase's sizes over several chunks. Returns the max abs difference
    seen."""
    from numbskull_tpu_torch.ops import stencil_kernel as sk
    log("== phase 2: lattice kernel vs plain version on the card "
        "(bit-equal)")
    worst = 0
    cases = STENCIL_FIXTURES + stencil_edge_fixtures() + tuple(
        (n, n, LATTICE_W, 0.0, *LATTICE_RUN) for n in LATTICES)
    for n, m, w, b, burn, epochs in cases:
        plan = sk.lattice_plan(n, m, burn + epochs)
        eq, tot, err = compare_stencil(torch, n, m, w, b, burn, epochs)
        log("  lattice %5dx%-6d w %6.2f b %5.2f burn %2d epochs %2d, tile "
            "%dx%d k %d, %d launches: %d of %d cells equal (x and count), "
            "max |diff| %d" % (n, m, w, b, burn, epochs, plan.tile_rows,
                               plan.tile_cols, plan.k, plan.launches, eq,
                               tot, err))
        if eq != tot or err != 0:
            fail("lattice kernel and plain version disagree on %dx%d w %g "
                 "b %g" % (n, m, w, b))
        worst = max(worst, err)
    return worst


def _equal_pair_share(x):
    """Share of a lattice's neighbour pairs with equal values."""
    eq = (x[1:, :] == x[:-1, :]).sum() + (x[:, 1:] == x[:, :-1]).sum()
    n, m = x.shape
    return float(eq) / ((n - 1) * m + n * (m - 1))


def phase_lattice(torch, card):
    """Phase 6: the lattice main path (GridGibbsEngine on the card) at
    1024x1024, checked against ItemGridEngine on the same model, then
    epoch-differenced rates at every size of LATTICES. Returns
    (launches, {n: {"kernel": (ups, ms), "plain": ...}})."""
    import numpy as np

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_color_hint, ising_grid
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops import stencil_kernel as sk
    from numbskull_tpu_torch.ops.stencil import GridGibbsEngine
    n = LATTICES[0]
    burn, epochs = 50, 200
    log("== phase 6: lattice main path, GridGibbsEngine %dx%d w %.1f on "
        "the card, %s" % (n, n, LATTICE_W, card))
    eng = GridGibbsEngine(n, n, LATTICE_W, device=DEVICE)
    st = eng.init_state(1)
    sk.STENCIL_LAUNCHES = 0
    t0 = time.perf_counter()
    st = eng.inference(st, seed=2, epochs=epochs, burn=burn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.STENCIL_LAUNCHES
    marg = eng.marginals(st, epochs)
    m_s, e_s = float(marg.mean()), _equal_pair_share(st.x)
    log("  inference(%d epochs, burn %d) took %.4f s, %d launches (plan "
        "%s); mean marginal %.4f, equal-neighbour share %.4f"
        % (epochs, burn, wall, launches,
           sk.lattice_plan(n, n, burn + epochs), m_s, e_s))
    want = sk.lattice_plan(n, n, burn + epochs).launches
    if launches != want:
        fail("lattice launches %d, the plan's %d" % (launches, want))
    if marg.shape != (n, n) or not np.isfinite(marg).all() or \
            int(st.count.max()) > epochs:
        fail("lattice marginals malformed")
    w, v, f, fm, dm, _ = ising_grid(n, n, weight=LATTICE_W)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    x, counts = pig.ItemGridEngine(cg, device=DEVICE).run(3, burn, epochs)
    m_i = float(counts[:, 1].double().mean()) / epochs
    e_i = _equal_pair_share(x.view(n, n))
    log("  ItemGridEngine on ising_grid(%d, %d, %.1f), checkerboard hint: "
        "mean marginal %.4f, equal-neighbour share %.4f"
        % (n, n, LATTICE_W, m_i, e_i))
    if abs(m_s - m_i) > 0.01 or abs(e_s - e_i) > 0.01 or \
            not 0.45 < m_s < 0.55:
        fail("lattice engine and itemgrid engine disagree on the model")
    result = {}
    for n in LATTICES:
        keng = GridGibbsEngine(n, n, LATTICE_W, device=DEVICE)
        x0 = sk.initial_lattice(1, n, n, DEVICE)
        # at least 8 ms of sweeps between a kernel's two points, above
        # the host's variation from call to call
        pts = {"kernel": (50, 2050) if n < 8192 else (8, 88),
               "plain": (2, 6) if n < 8192 else (1, 3)}
        fns = {"kernel": lambda e, keng=keng: keng.run(1, 0, e),
               "plain": lambda e, n=n, x0=x0: sk.grid_gibbs_reference(
                   x0, 1, 0, e, n=n, m=n, weight=LATTICE_W, bias=0.0)}
        meas = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            ups, ms = epoch_rate(torch, fns[which], n * n, *pts[which])
            meas.setdefault(which, []).append((ups, ms))
            log("  lattice %4dx%-4d %-6s %.6g variable updates/s, %.5f "
                "ms/epoch (epochs %d..%d)" % (n, n, which, ups, ms,
                                              *pts[which]))
        result[n] = {k: max(vs) for k, vs in meas.items()}
        by_kernel = {}
        busy = device_busy(torch, lambda keng=keng: keng.run(1, 0, 50),
                           by_kernel)
        log("  lattice %4dx%-4d kernel device busy share over 50 epochs: %s"
            % (n, n, "not measured (no device time in the trace)"
               if busy is None else "%.3f" % busy))
        log_kernel_times(by_kernel)
    return launches, result


def phase_hbm(torch, card):
    """Phase 7: engine="hbm" at 33.5 M variables through the library entry
    point (compile_graph, FactorGraph(engine="hbm")): inference and a few
    learning epochs, the sweep and learn kernels held bit for bit against
    their plain versions on the path's own tables, and the rates.
    Returns a dict of what it measured."""
    import numpy as np

    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_color_hint, ising_grid
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    n, m = HBM_GRID
    log("== phase 7: engine='hbm', Ising %dx%d (%d variables) with 30 %% "
        "evidence on the card, %s" % (n, m, n * m, card))
    out = {}

    t0 = time.perf_counter()
    w, v, f, fm, dm, _ = _with_evidence(ising_grid(
        n, m, weight=LATTICE_W, fixed=False), 0.3, 5)
    t1 = time.perf_counter()
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, m))
    out["model_s"], out["compile_s"] = t1 - t0, time.perf_counter() - t1
    log("  %dx%d: model %.2f s, compile_graph %.2f s: %d variables, %d "
        "colors" % (n, m, out["model_s"], out["compile_s"], cg.n_vars,
                    cg.n_colors))
    del w, v, f, fm, dm
    fg = cli.FactorGraph(cg, 0, seed=3, device=DEVICE, engine="hbm")
    burn, epochs, lrn = 2, 10, 3
    metrics.reset()
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    fg.inference(burn, epochs, sample_evidence=True)
    out["launches"] = pig.KERNEL_LAUNCHES
    lp = LearnParams(regularization=2, reg_param=1e-4)
    fg.learn(1, lrn, 0.05, 0.99, lp.regularization, lp.reg_param, 1)
    out["learn_launches"] = pig.LEARN_LAUNCHES
    out["learn_burn_launches"] = pig.KERNEL_LAUNCHES - out["launches"]
    tm = metrics.snapshot()["timings"]
    for k in ("itemgrid.build", "inference.sweep_s",
              "itemgrid.learn_tables", "learning.sweep_s"):
        out[k] = tm[k]["total_s"]
    log("  FactorGraph(engine='hbm'): engine build %.2f s, "
        "%d + %d epochs %.3f s (%d launches); learn tables %.2f s, 1 + %d "
        "epochs %.3f s (%d learn launches)"
        % (out["itemgrid.build"], burn, epochs,
           out["inference.sweep_s"], out["launches"],
           out["itemgrid.learn_tables"], lrn, out["learning.sweep_s"],
           out["learn_launches"]))
    eng = fg.engine(True)
    lt = eng.learn_tables()
    n_colors = live_steps(eng.tables)
    per_epoch = learn_launches_per_epoch(lt)
    if out["launches"] != (burn + epochs) * n_colors or \
            out["learn_launches"] != lrn * per_epoch or \
            out["learn_burn_launches"] != n_colors:
        fail("hbm path launches %d / %d / %d, expected %d / %d / %d" % (
            out["launches"], out["learn_launches"],
            out["learn_burn_launches"], (burn + epochs) * n_colors,
            lrn * per_epoch, n_colors))
    marg = fg.full_marginals(epochs)[:, 1]
    wt = fg.getWeights()
    log("  mean marginal %.4f over %d variables; weight after learning "
        "%.6f; learn tiles per color %s, partials per weight %s, %d learn "
        "launches per epoch" % (
            float(marg.mean()), len(marg), float(wt[0]), lt.n_tiles,
            lt.wt_np.tolist(), per_epoch))
    if not np.isfinite(marg).all() or not 0.45 < float(marg.mean()) < 0.55 \
            or float(wt[0]) == LATTICE_W:
        fail("hbm path outputs malformed or the weight did not move")
    out["sweep_cost"] = sweep_epoch_cost(torch, eng.tables)
    out["learn_cost"] = learn_epoch_cost(torch, lt)
    for which, pts in (("kernel", (4, 24)), ("plain", (1, 2))):
        out["infer_" + which] = rate(torch, eng, which == "plain", *pts)
        log("  33.5M inference %-6s %.6g variable updates/s, %.4f ms/epoch "
            "(epochs %d..%d)" % (which, *out["infer_" + which], *pts))
    out["learn_kernel"] = rate(torch, eng, False, 2, 6, lp=lp)
    log("  33.5M learning kernel %.6g variable updates/s, %.4f ms/epoch "
        "(epochs 2..6)" % out["learn_kernel"])
    for what, fn, per in (
            ("inference", lambda: eng.run(1, 0, 20), 20),
            ("learning", lambda: eng.learn(1, 0, 20, 0.1, 0.99, lp), 20)):
        by_kernel = {}
        busy = device_busy(torch, fn, by_kernel)
        log("  33.5M %s device busy share over %d epochs (set-up "
            "included): %s" % (what, per, "not measured" if busy is None
                               else "%.3f" % busy))
        log_kernel_times(by_kernel)
        if what == "inference":
            out["sweep_color_ms"] = log_sweep("33.5M, 20 epochs", by_kernel)
    out["err"] = check_equal(torch, "ising33M (hbm)", "own", eng, burn=1,
                             epochs=1)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["err_learn"] = check_learn_equal(torch, "ising33M (hbm)", eng, lp,
                                         burn=1, epochs=1)
    log("  learn comparison at full size took %.1f s"
        % (time.perf_counter() - t0))
    out["learn_plain"] = epoch_rate(
        torch, lambda e: _plain_learn(torch, eng, lp, 1, e), cg.n_vars, 1,
        2, tries=1, warm=False)
    log("  33.5M learning plain  %.6g variable updates/s, %.4f ms/epoch "
        "(epochs 1..2)" % out["learn_plain"])
    log("  host peak %.1f GB, device peak %.1f GB (plain versions' tensors "
        "included)" % (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                       / 1e6, torch.cuda.max_memory_allocated() / 1e9))
    return out


def _mc_graphs():
    """Phase 8's graphs: the 1024x1024 Ising of phase 3 (weight 0.25,
    fixed) for inference, and the same grid with a learnable weight and
    30 % evidence for learning, both under the checkerboard coloring."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_color_hint, ising_grid
    hint = ising_color_hint(GRID, GRID)
    w, v, f, fm, dm, _ = ising_grid(GRID, GRID, weight=0.25)
    infer = compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint)
    w, v, f, fm, dm, _ = _with_evidence(ising_grid(
        GRID, GRID, weight=0.25, fixed=False), 0.3, 6)
    return infer, compile_graph(w, v, f, fm, domain_mask=dm,
                                color_hint=hint)


def _mc_lp():
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    return LearnParams(regularization=2, reg_param=1e-4)


# (seed, burn, epochs) of phase 8's runs and (seed, burn, epochs,
# stepsize, decay) of its learning
MC_RUN = (5, 2, 3)
MC_LEARN_ARGS = (9, 1, 2, 0.05, 0.99)


def _gloo_worker(rank, group, out_dir):
    """One process of phase 8's 2-process gloo run on the one card: the
    engine over the group (shard ``rank``), run and learn as the parent
    does in one process; results and the epoch time to ``out_dir``."""
    import torch
    from numbskull_tpu_torch.ops.itemgrid_mc import MultiChipItemGridEngine
    infer, lcg = _mc_graphs()
    eng = MultiChipItemGridEngine(infer, group=group, device=DEVICE)
    x, counts = eng.run(*MC_RUN)
    leng = MultiChipItemGridEngine(lcg, group=group, device=DEVICE)
    w, xl, xel = leng.learn(*MC_LEARN_ARGS, lp=_mc_lp())
    times = {}
    for lo, hi in ((2, 6),):
        for e in (lo, hi):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(1, 0, e)
            torch.cuda.synchronize()
            times[e] = time.perf_counter() - t0
    torch.save({"x": x.cpu(), "counts": counts.cpu(), "w": w.cpu(),
                "xl": xl.cpu(), "xel": xel.cpu(),
                "epoch_ms": (times[6] - times[2]) / 4 * 1e3,
                "backend": eng.backend},
               os.path.join(out_dir, "rank%d.pt" % rank))


def _shard_costs(torch, tables, learn=False):
    """(bytes, operations) of one epoch over every shard's tables."""
    costs = [learn_epoch_cost(torch, t) if learn else
             sweep_epoch_cost(torch, t) for t in tables]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def _received(eng):
    """Rows that the replicas receive per epoch: every step's rows, once
    for each replica that does not own them."""
    return sum((len(r.offs_host) - 2) * r.offs_host[-1] for r in eng.rows)


def phase_mc(torch, card):
    """Phase 8: the graph-sharded engine (MultiChipItemGridEngine) on the
    1024x1024 Ising: in-process shards, kernels against plain versions,
    launches, epoch times at 1, 2 and 4 shards with the exchange's share
    of the device time, the unpack kernel alone, and a 2-process gloo
    run on the one card. Returns a dict of what it measured."""
    import numpy as np

    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops import itemgrid_mc as mc
    from numbskull_tpu_torch.parallel import multihost
    log("== phase 8: graph-sharded engine, Ising %dx%d, %d shards in one "
        "process and 2 gloo processes on the card, %s"
        % (GRID, GRID, MC_SHARDS, card))
    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    infer, lcg = _mc_graphs()
    eng = mc.MultiChipItemGridEngine(infer, n_shards=MC_SHARDS,
                                     device=DEVICE)
    log("  graphs compiled and %d shards' tables built in %.2f s; rows "
        "per shard and color %s" % (MC_SHARDS, time.perf_counter() - t0,
                                    [t.n_rows for t in eng.tables]))

    def counted(fn):
        pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
        mc.EXCHANGE_LAUNCHES = 0
        res = fn()
        torch.cuda.synchronize()
        return res, (pig.KERNEL_LAUNCHES, pig.LEARN_LAUNCHES,
                     mc.EXCHANGE_LAUNCHES)

    seed, burn, epochs = MC_RUN
    (xr, cr), n_run = counted(lambda: eng.run(seed, burn, epochs))
    (xe, ce), n_emu = counted(lambda: eng.run_emulated(seed, burn, epochs))
    xp, cp = eng.run(seed, burn, epochs, plain=True)
    xpe, cpe = eng.run_emulated(seed, burn, epochs, plain=True)
    torch.cuda.synchronize()
    busy_steps = sum(1 for t in eng.tables for n in t.n_rows if n > 0)
    recv_steps = sum(sum(1 for d in range(MC_SHARDS)
                         if r.offs_host[-1] - (r.offs_host[d + 1] -
                                               r.offs_host[d]) > 0)
                     for r in eng.rows)
    sweeps = (burn + epochs) * busy_steps
    emu = (burn + epochs) * sum(live_steps(t) for t in eng.tables)
    log("  run: %d sweep and %d unpack launches (expected %d, %d); "
        "run_emulated: %d sweep, %d unpack (expected %d, 0)"
        % (n_run[0], n_run[2], sweeps, (burn + epochs) * recv_steps,
           n_emu[0], n_emu[2], emu))
    if n_run != (sweeps, 0, (burn + epochs) * recv_steps) or \
            n_emu != (emu, 0, 0):
        fail("sharded engine launches not as counted")
    out["launches_run"], out["launches_exchange"] = n_run[0], n_run[2]
    out["launches_emu"] = n_emu[0]
    pairs = {"run == run_emulated": (xr, cr, xe, ce),
             "run == plain run": (xr, cr, xp, cp),
             "run_emulated == plain run_emulated": (xe, ce, xpe, cpe)}
    out["err_run"] = out["err_emu"] = 0
    for what, (a, ca, b, cb) in pairs.items():
        err = max(int((a - b).abs().max()), int((ca - cb).abs().max()))
        log("  %-36s values %s, counts %s, max |diff| %d" % (
            what, torch.equal(a, b), torch.equal(ca, cb), err))
        if not (torch.equal(a, b) and torch.equal(ca, cb)):
            fail("sharded engine: %s differs" % what)
    mean = float(cr[:, 1].double().mean()) / epochs
    log("  tallies %d (= %d epochs x %d variables), mean marginal %.4f"
        % (int(cr.sum()), epochs, infer.n_vars, mean))
    if int(cr.sum()) != epochs * infer.n_vars or not 0.4 < mean < 0.6:
        fail("sharded engine tallies or marginals malformed")

    # learning, kernels against plain, bit for bit
    leng = mc.MultiChipItemGridEngine(lcg, n_shards=MC_SHARDS,
                                      device=DEVICE)
    lp = _mc_lp()
    lseed, lburn, lepochs, step, decay = MC_LEARN_ARGS
    (wk, xk, xek), n_lrn = counted(
        lambda: leng.learn(lseed, lburn, lepochs, step, decay, lp))
    wp, xlp, xelp = leng.learn(lseed, lburn, lepochs, step, decay, lp,
                               plain=True)
    torch.cuda.synchronize()
    lts = leng.learn_tables()
    per_step = sum(learn_launches_per_epoch(lt) for lt in lts) + \
        leng.n_steps
    lbusy = sum(1 for t in leng.tables for n in t.n_rows if n > 0)
    lrecv = sum(sum(1 for d in range(MC_SHARDS)
                    if r.offs_host[-1] - (r.offs_host[d + 1] -
                                          r.offs_host[d]) > 0)
                for r in leng.rows)
    want = (lburn * lbusy, lepochs * per_step, (lburn + lepochs) * lrecv)
    out["err_learn"] = max(float((wk - wp).abs().max()),
                           float((xk - xlp).abs().max()),
                           float((xek - xelp).abs().max()))
    same = _bits_equal(torch, wk, wp) and torch.equal(xk, xlp) and \
        torch.equal(xek, xelp)
    log("  learn %d + %d epochs: weight %.8f (plain %.8f, from %.2f); "
        "weights and both chains bit-equal %s; launches sweep/learn/unpack "
        "%s (expected %s)" % (lburn, lepochs, float(wk[0]), float(wp[0]),
                              float(lcg.weight_init[0]), same, n_lrn,
                              want))
    if not same:
        fail("sharded learn kernels and plain version disagree")
    if n_lrn != want:
        fail("sharded learn launches not as counted")
    if float(wk[0]) == float(lcg.weight_init[0]):
        fail("sharded learning did not move the weight")
    out["launches_learn"] = n_lrn[1]

    # epoch times: kernels at 1, 2 and 4 shards, plain at 4; the
    # exchange's share of the device time from the profiler's rows
    engines = {MC_SHARDS: eng}
    for n_g in (1, 2):
        engines[n_g] = mc.MultiChipItemGridEngine(infer, n_shards=n_g,
                                                  device=DEVICE)
    out["run_ms"], out["share"] = {}, {}
    for n_g in (1, 2, MC_SHARDS):
        e = engines[n_g]
        out["run_ms"][n_g] = min(epoch_rate(
            torch, lambda k, e=e: e.run(1, 0, k), infer.n_vars, 20, 120)[1]
            for _ in range(2))
        by_kernel = {}
        device_busy(torch, lambda e=e: e.run(1, 0, 20), by_kernel)
        tot = sum(us for _, us in by_kernel.values())
        unp = sum(us for k, (_, us) in by_kernel.items() if "unpack" in k)
        out["share"][n_g] = unp / tot if tot else None
        log("  run, %d shard(s): %.4f ms/epoch (CUDA events, epochs "
            "20..120); exchange %s of the device time over 20 epochs"
            % (n_g, out["run_ms"][n_g], "not measured" if not tot else
               "%.3f" % out["share"][n_g]))
        log_kernel_times(by_kernel)
        log_sweep("%d shard(s), 20 epochs (a launch per color and shard)"
                  % n_g, by_kernel)
    out["emu_ms"] = epoch_rate(torch, lambda k: eng.run_emulated(1, 0, k),
                               infer.n_vars, 20, 120)[1]
    out["run_plain_ms"] = epoch_rate(
        torch, lambda k: eng.run(1, 0, k, plain=True), infer.n_vars, 1, 3,
        tries=1)[1]
    out["emu_plain_ms"] = epoch_rate(
        torch, lambda k: eng.run_emulated(1, 0, k, plain=True),
        infer.n_vars, 1, 3, tries=1)[1]
    out["learn_ms"] = epoch_rate(
        torch, lambda k: leng.learn(1, 0, k, step, decay, lp),
        lcg.n_vars, 10, 50)[1]
    leng1 = mc.MultiChipItemGridEngine(lcg, n_shards=1, device=DEVICE)
    out["learn1_ms"] = min(epoch_rate(
        torch, lambda k: leng1.learn(1, 0, k, step, decay, lp),
        lcg.n_vars, 10, 50)[1] for _ in range(2))
    by_kernel = {}
    device_busy(torch, lambda: leng1.learn(1, 0, 20, step, decay, lp),
                by_kernel)
    log("  learning, 1 shard: %.4f ms/epoch (CUDA events, epochs 10..50); "
        "device time per kernel over 20 epochs:" % out["learn1_ms"])
    log_kernel_times(by_kernel)
    by_kernel = {}
    device_busy(torch, lambda: leng.learn(1, 0, 20, step, decay, lp),
                by_kernel)
    log("  learning, %d shards: device time per kernel over 20 epochs:"
        % MC_SHARDS)
    log_kernel_times(by_kernel)
    # a warm-up epoch and the best of two a point: the host's noise at one
    # try can exceed the one epoch between the points
    out["learn_plain_ms"] = epoch_rate(
        torch, lambda k: leng.learn(1, 0, k, step, decay, lp, plain=True),
        lcg.n_vars, 1, 3)[1]
    log("  %d shards: run_emulated %.4f ms/epoch, learning %.4f ms/epoch; "
        "plain run %.2f, plain run_emulated %.2f, plain learning %.2f "
        "ms/epoch" % (MC_SHARDS, out["emu_ms"], out["learn_ms"],
                      out["run_plain_ms"], out["emu_plain_ms"],
                      out["learn_plain_ms"]))
    sb, so = _shard_costs(torch, eng.tables)
    rows = sum(r.offs_host[-1] for r in eng.rows)
    recv = _received(eng)
    out["run_cost"] = (sb + 4 * rows + 12 * recv, so)
    out["emu_cost"] = (sb, so)
    lb, lo_ = _shard_costs(torch, leng.learn_tables(), learn=True)
    out["learn_cost"] = (lb + 8 * sum(r.offs_host[-1] for r in leng.rows)
                         + 20 * _received(leng) + 12 * MC_SHARDS *
                         lcg.n_weights * leng.n_steps, lo_)

    # the unpack kernel alone, at the main path's shape (step 0, shard
    # 0's replica receiving the other shards' rows)
    r0 = eng.rows[0]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    pay = torch.randint(0, 2, (MC_SHARDS, r0.rs), dtype=torch.int32,
                        device=DEVICE, generator=gen)
    xk = torch.full((infer.n_vars,), 7, dtype=torch.int32, device=DEVICE)
    xq = xk.clone()
    mc.unpack(r0, pay, xk, None, 0)
    mc.unpack_reference(r0, pay, xq, None, 0)
    torch.cuda.synchronize()
    out["err_unpack"] = int((xk - xq).abs().max())
    o = r0.offs_host
    vid = r0.vid[o[1]:].to(torch.int64)
    buf = torch.cat([pay[d, :o[d + 1] - o[d]]
                     for d in range(1, MC_SHARDS)])
    xl = xk.clone()
    xl.index_copy_(0, vid, buf)
    n_recv = int(vid.numel())
    if out["err_unpack"] or not torch.equal(xl, xk):
        fail("unpack kernel, its plain version and index_copy_ disagree")
    # a call of the wrapper costs more host time than the kernel takes on
    # the device, so each is timed both ways: CUDA events over 50 calls
    # back to back (host included), and each call's device time from the
    # profiler's device rows; kernel and library in turns (kernel,
    # library, library, kernel), the median call over both turns (the
    # record's numbers)
    fns = {"kernel": lambda: mc.unpack(r0, pay, xk, None, 0),
           "plain": lambda: mc.unpack_reference(r0, pay, xq, None, 0),
           "library": lambda: xl.index_copy_(0, vid, buf)}
    reps = 50
    t_host, rows = {}, {}
    for which in ("plain", "kernel", "library", "library", "kernel",
                  "plain"):
        fn = fns[which]
        fn()
        ms = _time_epochs(torch, lambda k: [fn() for _ in range(k)], reps)
        t_host[which] = min(t_host.get(which, 1e30), ms / reps)
        rows.setdefault(which, []).append(device_rows_us(torch, fn, reps))
    med = {k: median_call_ms(turns, reps) for k, turns in rows.items()}
    # the plain version's device time per call, from the turns whose
    # trace holds its device rows (a trace may drop a whole turn's)
    plain = [x for x in (sum(sum(t.values(), [])) for t in rows["plain"])
             if x > 0]
    if not plain:
        fail("plain unpack: no device rows in any turn's trace")
    med["plain"] = min(plain) / reps / 1e3
    out["unpack_ms"], out["unpack_plain_ms"], out["unpack_lib_ms"] = (
        med["kernel"], med["plain"], med["library"])
    out["unpack_cost"] = (12 * n_recv, 0)
    log("  unpack of %d rows (shard 0's replica, step 0), median device "
        "time per call over %d calls each (in turns: kernel, library, "
        "library, kernel): kernel %.5f ms, index_copy_ %.5f ms; plain %.5f "
        "ms (total / calls); with the host (CUDA events, %d calls): %.5f, "
        "%.5f, %.5f ms; equal" % (
            n_recv, 2 * reps, med["kernel"], med["library"], med["plain"],
            reps, t_host["kernel"], t_host["library"], t_host["plain"]))

    # two processes on the one card, gloo through host memory
    ref2 = engines[2].run(*MC_RUN)
    leng2 = mc.MultiChipItemGridEngine(lcg, n_shards=2, device=DEVICE)
    lref2 = leng2.learn(*MC_LEARN_ARGS, lp=lp)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="nsx_gloo_") as tmp:
        t0 = time.perf_counter()
        multihost.spawn(_gloo_worker, 2, (tmp,), backend="gloo")
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, "rank%d.pt" % r))
               for r in range(2)]
    ok = all(torch.equal(r["x"], ref2[0].cpu()) and
             torch.equal(r["counts"], ref2[1].cpu()) and
             _bits_equal(torch, r["w"], lref2[0].cpu()) and
             torch.equal(r["xl"], lref2[1].cpu()) and
             torch.equal(r["xel"], lref2[2].cpu()) for r in res)
    out["gloo_ms"] = res[0]["epoch_ms"]
    log("  2 processes, backend %s, transport through host memory (one "
        "card, not a multi-card number): both ranks' values, counts and "
        "learned weights == in-process 2 shards: %s; %.4f ms/epoch on "
        "rank 0 (wall clock, epochs 2..6; in-process 2 shards %.4f); "
        "spawn to exit %.1f s" % (res[0]["backend"], ok, out["gloo_ms"],
                                  out["run_ms"][2], wall))
    if not ok:
        fail("gloo ranks disagree with the in-process run")
    return out


def mc_records(mcr):
    """The kernels-line records of kernels #3, #4, #5 and #9."""
    recs = [
        dict(MC_SWEEP, launches=mcr["launches_run"],
             max_abs_err=mcr["err_run"], ms=mcr["run_ms"][MC_SHARDS],
             plain_ms=mcr["run_plain_ms"], cost=mcr["run_cost"],
             library_ms=None),
        dict(MC_LEARN, launches=mcr["launches_learn"],
             max_abs_err=mcr["err_learn"], ms=mcr["learn_ms"],
             plain_ms=mcr["learn_plain_ms"], cost=mcr["learn_cost"],
             library_ms=None),
        dict(MC_ONE_COLOR, launches=mcr["launches_emu"],
             max_abs_err=mcr["err_emu"], ms=mcr["emu_ms"],
             plain_ms=mcr["emu_plain_ms"], cost=mcr["emu_cost"],
             library_ms=None),
        dict(EXCHANGE, launches=mcr["launches_exchange"],
             max_abs_err=mcr["err_unpack"], ms=mcr["unpack_ms"],
             plain_ms=mcr["unpack_plain_ms"], cost=mcr["unpack_cost"],
             library_ms=mcr["unpack_lib_ms"])]
    for rec in recs:
        rec["bound_ms"], rec["bound_by"] = bound(*rec.pop("cost"))
    return recs


def _bsp_clone(state):
    """A copy of a BSPItemGridInference's state."""
    import dataclasses
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def _bsp_diff(torch, a, b, names):
    """(all bit-equal, max abs difference) of the named state fields."""
    same = all(_bits_equal(torch, getattr(a, n), getattr(b, n))
               for n in names)
    err = max(float((getattr(a, n).double() - getattr(b, n).double())
                    .abs().max()) for n in names)
    return same, err


def _bsp_partition(model, n_parts):
    """Phase 9's partition, chosen as run_distributed chooses it."""
    from numbskull_tpu_torch.compile import conflict_edges
    from numbskull_tpu_torch.parallel.partition import choose_partition
    w, v, f, fm, _, _ = model
    t0 = time.perf_counter()
    part, report = choose_partition(len(v), conflict_edges(v, f, fm),
                                    n_parts)
    log("  partition into %d parts: %s, sizes %s, %.2f s" % (
        n_parts, report["chosen"], [int((part == p).sum())
                                    for p in range(n_parts)],
        time.perf_counter() - t0))
    return part


def _kernel_call_ms(torch, fn, names):
    """Device time per launch of kernels whose name holds one of
    ``names`` in a trace of fn(), or None when the trace shows none."""
    by_kernel = {}
    device_busy(torch, fn, by_kernel)
    hits = [(c, us) for k, (c, us) in by_kernel.items()
            if any(n in k for n in names)]
    calls = sum(c for c, _ in hits)
    return sum(us for _, us in hits) / 1e3 / calls if calls else None


def _split_ms(torch, pieces, n=20):
    """CUDA-event ms of one call of each piece (name, fn), n calls back
    to back after one warm-up call."""
    out = {}
    for name, fn in pieces:
        fn()
        out[name] = _time_epochs(
            torch, lambda k: [fn() for _ in range(k)], n) / n
    return out


def _bsp_infer_case(torch, model, part, mode, out):
    """Phase 9 (a), one mode: BSPItemGridInference on the kernels (the
    main path, counted), then the same run through the plain versions
    from the same state, bit for bit; then rates."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.parallel.bsp import BSPItemGridInference
    w, v, f, fm, dm, _ = model
    t0 = time.perf_counter()
    eng = BSPItemGridInference(w, v, f, fm, part, mode=mode, domain_mask=dm,
                               device=DEVICE)
    log("  %s: %d parts built in %.2f s (compile + tables)%s" % (
        mode, eng.n_parts, time.perf_counter() - t0,
        "" if eng.msg_plan is None else "; %d message targets"
        % eng.msg_plan.n_targets))
    seed, burn, epochs = BSP_RUN
    start = _bsp_clone(eng.state)
    pig.KERNEL_LAUNCHES = pig.EXT_LAUNCHES = 0
    t0 = time.perf_counter()
    eng.inference(seed, epochs, burn=burn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (pig.KERNEL_LAUNCHES, pig.EXT_LAUNCHES)
    kern = _bsp_clone(eng.state)
    eng.state = _bsp_clone(start)
    eng.inference(seed, epochs, burn=burn, plain=True)
    torch.cuda.synchronize()
    same, err = _bsp_diff(torch, kern, eng.state, ("values", "counts"))
    steps = sum(live_steps(e.tables) for e in eng.engines)
    want = ((burn + epochs) * steps,
            (burn + epochs) * steps if mode == "messages" else 0)
    mean = float(kern.counts[:, 1].double().mean()) / epochs
    log("  %s: %d + %d syncs in %.3f s; sweep / ext launches %s (expected "
        "%s); kernels == plain (values, tallies): %s, max |diff| %g; "
        "tallies %d, mean marginal %.4f" % (
            mode, burn, epochs, wall, launches, want, same, err,
            int(kern.counts.sum()), mean))
    if not same:
        fail("BSP %s inference: kernels and plain versions disagree" % mode)
    if launches != want:
        fail("BSP %s inference launches %s, expected %s" % (mode, launches,
                                                            want))
    if int(kern.counts.sum()) != epochs * len(v) or not 0.4 < mean < 0.6:
        fail("BSP %s inference tallies or marginals malformed" % mode)
    out["err"] = max(out.get("err", 0.0), err)
    if mode == "messages":
        out["ext_launches"] = out.get("ext_launches", 0) + launches[1]

    # rates: ms per sync (epoch-differenced), its split, the busy share
    r = out.setdefault(mode, {})
    r["sync_ms"] = min(epoch_rate(torch, lambda k: eng.inference(1, k),
                                  len(v), 10, 50)[1] for _ in range(2))
    ext = eng._messages(eng.state.values)
    holder = {}

    def sweeps():
        holder["outs"] = eng._sweep_parts(1, 0, 1, ext)

    pieces = [("sweeps", sweeps),
              ("exchange", lambda: eng._exchange(holder["outs"], True))]
    if mode == "messages":
        pieces.insert(0, ("messages",
                          lambda: eng._messages(eng.state.values)))
    r["split"] = _split_ms(torch, pieces)
    r["busy"] = device_busy(torch, lambda: eng.inference(1, 20))
    log("  %s: %.4f ms per sync (CUDA events, syncs 10..50); split %s ms; "
        "device busy share over 20 syncs %s" % (
            mode, r["sync_ms"], {k: round(x, 4) for k, x in
                                 r["split"].items()},
            "not measured" if r["busy"] is None else "%.3f" % r["busy"]))
    if mode == "messages":
        # the has_ext form alone on part 0's tables, against the same
        # launches without the table
        e0 = eng.engines[0]
        r["ext_call_ms"] = _kernel_call_ms(
            torch, lambda: e0.run(1, 0, 20, ext_pot=ext), SWEEP_KERNELS)
        r["noext_call_ms"] = _kernel_call_ms(
            torch, lambda: e0.run(1, 0, 20), SWEEP_KERNELS)
        log("  " + sweep_resources())
        out["sweep_ms"] = min(epoch_rate(
            torch, lambda k: e0.run(1, 0, k, ext_pot=ext), len(v), 20,
            120)[1] for _ in range(2))
        out["sweep_plain_ms"] = epoch_rate(
            torch, lambda k: e0.run(1, 0, k, ext_pot=ext, plain=True),
            len(v), 1, 3, tries=1)[1]
        nb, ops = sweep_epoch_cost(torch, e0.tables)
        out["sweep_cost"] = (nb + 4 * len(v) * e0.cg.kmax, ops)
        log("  has_ext sweep on part 0's tables: %.4f ms per part-epoch "
            "(plain %.2f); device time per launch %s ms with the table, "
            "%s without" % (out["sweep_ms"], out["sweep_plain_ms"],
                            r["ext_call_ms"], r["noext_call_ms"]))
    del eng
    torch.cuda.empty_cache()


def _bsp_learn_case(torch, name, model, part, args, out, rates=False):
    """Phase 9 (b), one graph: messages-mode BSPItemGridInference.learn
    on the kernels (counted), then through the plain versions from the
    same state: weights and both chains bit for bit."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    from numbskull_tpu_torch.parallel.bsp import BSPItemGridInference
    w, v, f, fm, dm, _ = model
    lp = LearnParams(regularization=2, reg_param=1e-4)
    seed, burn, epochs, step, decay = args
    t0 = time.perf_counter()
    eng = BSPItemGridInference(w, v, f, fm, part, mode="messages",
                               domain_mask=dm, device=DEVICE)
    log("  %s: %d parts built in %.2f s" % (name, eng.n_parts,
                                          time.perf_counter() - t0))
    start = _bsp_clone(eng.state)
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    pig.EXT_LAUNCHES = pig.EXT_LEARN_LAUNCHES = 0
    t0 = time.perf_counter()
    eng.learn(seed, epochs, step, decay, burn=burn, lp=lp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = (pig.KERNEL_LAUNCHES, pig.EXT_LAUNCHES, pig.LEARN_LAUNCHES,
         pig.EXT_LEARN_LAUNCHES)
    kern = _bsp_clone(eng.state)
    eng.state = _bsp_clone(start)
    eng.learn(seed, epochs, step, decay, burn=burn, lp=lp, plain=True)
    torch.cuda.synchronize()
    fields = ("weights", "values", "values_evid")
    same, err = _bsp_diff(torch, kern, eng.state, fields)
    steps = sum(1 for e in eng.engines for r in e.tables.n_rows if r > 0)
    live = sum(live_steps(e.tables) for e in eng.engines)
    moved = not torch.equal(kern.weights, start.weights)
    log("  %s: %d burn-in syncs + %d epochs in %.3f s; launches sweep %d "
        "(ext %d), learn %d (ext step %d); weights %s (from %s); kernels "
        "== plain (weights, both chains): %s, max |diff| %g" % (
            name, burn, epochs, wall, n[0], n[1], n[2], n[3],
            [round(float(x), 6) for x in kern.weights.cpu()],
            [float(x) for x in start.weights.cpu()], same, err))
    if not same:
        fail("BSP learning on %s: kernels and plain versions disagree"
             % name)
    if n[0] != burn * live or n[1] != n[0] or n[3] != epochs * steps or \
            not moved:
        fail("BSP learning on %s: launches %s (expected sweep %d, learn "
             "steps %d, all with ext) or the weights did not move"
             % (name, n, burn * live, epochs * steps))
    out["err_learn"] = max(out.get("err_learn", 0.0), err)
    out["ext_learn_launches"] = out.get("ext_learn_launches", 0) + n[3]
    out["ext_launches"] = out.get("ext_launches", 0) + n[1]
    if not rates:
        return
    r = out.setdefault("learn", {})
    r["sync_ms"] = epoch_rate(
        torch, lambda k: eng.learn(1, k, step, decay, lp=lp), len(v), 2,
        6)[1]
    ext = eng._messages(eng.state.values)
    ext_e = eng._messages(eng.state.values_evid)
    holder = {}

    def parts():
        holder["outs"] = eng._learn_parts(1, 0, step, lp, ext, ext_e)

    r["split"] = _split_ms(torch, [
        ("messages", lambda: (eng._messages(eng.state.values),
                              eng._messages(eng.state.values_evid))),
        ("part learns", parts),
        ("exchange", lambda: eng._learn_exchange(holder["outs"]))], n=5)
    r["busy"] = device_busy(torch, lambda: eng.learn(1, 5, step, lp=lp))
    e0 = eng.engines[0]
    r["ext_call_ms"] = _kernel_call_ms(
        torch, lambda: e0.learn(1, 0, 5, step, lp=lp, ext_pot=ext,
                                ext_pot_evid=ext_e), LEARN_STEP_KERNELS)
    r["noext_call_ms"] = _kernel_call_ms(
        torch, lambda: e0.learn(1, 0, 5, step, lp=lp), LEARN_STEP_KERNELS)
    log("  %s: %.4f ms per learning sync (CUDA events, epochs 2..6); split "
        "%s ms; device busy share over 5 syncs %s; learn step device time "
        "per launch %s ms with the tables, %s without" % (
            name, r["sync_ms"], {k: round(x, 4) for k, x in
                                 r["split"].items()},
            "not measured" if r["busy"] is None else "%.3f" % r["busy"],
            r["ext_call_ms"], r["noext_call_ms"]))
    out["learn_ms"] = epoch_rate(
        torch, lambda k: e0.learn(1, 0, k, step, lp=lp, ext_pot=ext,
                                  ext_pot_evid=ext_e), len(v), 2, 6)[1]
    out["learn_plain_ms"] = epoch_rate(
        torch, lambda k: e0.learn(1, 0, k, step, lp=lp, ext_pot=ext,
                                  ext_pot_evid=ext_e, plain=True), len(v),
        1, 3)[1]
    nb, ops = learn_epoch_cost(torch, e0.learn_tables())
    out["learn_cost"] = (nb + 8 * len(v) * e0.cg.kmax, ops)
    log("  has_ext learning on part 0's tables: %.4f ms per part-epoch "
        "(plain %.2f)" % (out["learn_ms"], out["learn_plain_ms"]))
    del eng
    torch.cuda.empty_cache()


def _bsp_cli(torch, workdir, out):
    """Phase 9 (c): the CLI's --parts on the Ising of phase 3 and the coin
    graph of phase 4 (parallel/bsp.BSPEngine over the tensor-op
    GibbsEngine)."""
    import numpy as np

    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.models import coin_model, ising_grid
    from numbskull_tpu_torch.observability import metrics
    idir, cdir = (os.path.join(workdir, "bsp_" + n) for n in ("ising",
                                                              "coin"))
    w, v, f, fm, _, _ = ising_grid(GRID, GRID, weight=0.25)
    dataloading.write_factor_graph_files(idir, w, v, f, fm)
    w, v, f, fm, _, _ = coin_model(COIN_COPIES, *COIN_TRUTH, evidence=True,
                                   fixed=False, seed=3)
    dataloading.write_factor_graph_files(cdir, w, v, f, fm)
    phases = ("partition", "compile", "learning", "inference", "dump")
    runs = (("ising", idir, ["--parts", str(BSP_PARTS), "-l", "0", "-i",
                             "100", "-b", "10"]),
            ("coin", cdir, ["--parts", "2", "-l", "150", "-i", "100", "-b",
                            "10", "-s", "0.1", "-d", "0.99", "-r", "1e-4"]))
    for name, src, flags in runs:
        dst = os.path.join(workdir, "bsp_out_" + name)
        metrics.reset()
        t0 = time.perf_counter()
        ns = cli.main([src, *flags, "-o", dst, "-q", "--device", DEVICE])
        wall = time.perf_counter() - t0
        tm = metrics.snapshot()["timings"]
        split = {p: tm["distributed.%s_s" % p]["total_s"] for p in phases}
        out["cli_" + name] = dict(split, wall=wall)
        res = ns.distributed
        log("  CLI %s: main() %.2f s = %s + load %.2f s; %d parts (%s, %s),"
            " traffic %s" % (" ".join(flags[:2]), wall, ", ".join(
                "%s %.3f" % kv for kv in split.items()),
                wall - sum(split.values()), res["n_parts"],
                res["partition"], res["mode"], res["traffic"]))
        paths = [os.path.join(dst, "inference_result.out" + s)
                 for s in (".text", ".weights.text")]
        for p in paths:
            if not os.path.isfile(p):
                fail("CLI --parts: missing output " + p)
        rows = np.loadtxt(paths[0], ndmin=2)
        got = np.loadtxt(paths[1], ndmin=2)[:, 1]
        if name == "ising":
            mean = float(rows[:, 2].mean())
            log("    %d marginal rows, mean marginal %.4f" % (len(rows),
                                                             mean))
            if rows.shape != (GRID * GRID, 3) or abs(mean - 0.5) > 0.05:
                fail("CLI --parts 4: Ising marginals malformed or mean "
                     "%.4f not within 0.05 of 0.5" % mean)
        else:
            log("    learned weights %s (truth %s)" % (
                np.array2string(got, precision=4), COIN_TRUTH))
            if rows.shape != (2 * COIN_COPIES, 3) or \
                    (np.sign(got) != np.sign(COIN_TRUTH)).any():
                fail("CLI --parts 2: coin outputs malformed or weights %s "
                     "without the truth's signs" % got)


def phase_bsp(torch, card):
    """Phase 9: partitioned (BSP) execution. (a) BSPItemGridInference on
    the 1M Ising, 4 parts, values and messages mode; (b) its learning in
    messages mode on the coin graph split pairwise and on the 1M Ising
    with 30 % evidence; (c) the CLI's --parts. Returns a dict of what it
    measured."""
    import numpy as np

    from numbskull_tpu_torch.models import coin_model, ising_grid
    log("== phase 9: partitioned (BSP) execution, %s" % card)
    torch.cuda.empty_cache()
    out = {}
    model = ising_grid(GRID, GRID, weight=0.25)
    log("  (a) BSPItemGridInference, Ising %dx%d, %d parts" % (
        GRID, GRID, BSP_PARTS))
    part = _bsp_partition(model, BSP_PARTS)
    for mode in ("values", "messages"):
        _bsp_infer_case(torch, model, part, mode, out)

    log("  (b) BSPItemGridInference.learn, messages mode")
    coin = coin_model(COIN_COPIES, *COIN_TRUTH, evidence=True, fixed=False,
                      seed=3)
    pairwise = np.arange(2 * COIN_COPIES) % 2
    _bsp_learn_case(torch, "coin%dk pairwise" % (2 * COIN_COPIES // 1000),
                    coin, pairwise, (5, 2, 3, 0.1, 0.99), out)
    ising_ev = _with_evidence(ising_grid(GRID, GRID, weight=0.25,
                                         fixed=False), 0.3, 6)
    # evidence leaves the factors, hence the conflict edges and the
    # partition chosen from them, as in (a)
    _bsp_learn_case(torch, "ising1024 ev30", ising_ev, part,
                    (9, 0, 2, 0.05, 0.99), out, rates=True)

    log("  (c) the CLI's --parts (BSPEngine on the tensor-op GibbsEngine)")
    with tempfile.TemporaryDirectory(prefix="nsx_chip_bsp_") as work:
        _bsp_cli(torch, work, out)
    return out


def bsp_records(b):
    """The kernels-line records of the has_ext forms of kernels #1 and
    #2: per part-epoch on part 0's tables of the 1M Ising."""
    recs = [dict(SWEEP_EXT, launches=b["ext_launches"], max_abs_err=b["err"],
                 ms=b["sweep_ms"], plain_ms=b["sweep_plain_ms"],
                 cost=b["sweep_cost"], library_ms=None),
            dict(LEARN_EXT, launches=b["ext_learn_launches"],
                 max_abs_err=b["err_learn"], ms=b["learn_ms"],
                 plain_ms=b["learn_plain_ms"], cost=b["learn_cost"],
                 library_ms=None)]
    for rec in recs:
        rec["bound_ms"], rec["bound_by"] = bound(*rec.pop("cost"))
    return recs


def _f1_graphs(workdir):
    """Phase 10 (a)'s graphs as DeepDive files: a 4x4 Potts graph of
    cardinality 130 with a learnable coupling and 30 % evidence, and
    voting_model(400, 1, 300) (301 colors)."""
    import numpy as np

    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch.models import potts_grid, voting_model
    pdir, vdir = (os.path.join(workdir, n) for n in ("potts130",
                                                     "voting301"))
    w, v, f, fm, _, _ = potts_grid(4, 4, card=130, weight=0.3, fixed=False)
    rng = np.random.default_rng(0)
    v["isEvidence"] = (rng.random(16) < 0.3).astype(np.int8)
    v["initialValue"] = rng.integers(0, 130, 16)
    dataloading.write_factor_graph_files(pdir, w, v, f, fm)
    w, v, f, fm, _, _ = voting_model(400, 1, 300)
    dataloading.write_factor_graph_files(vdir, w, v, f, fm)
    return (("potts130", pdir, ["-l", "20", "-i", "200", "-b", "10"],
             "cardinality 130 > 128", 16 * 130),
            ("voting301", vdir, ["-i", str(VOTE_EPOCHS)],
             "301 colors > 256", 400))


def _gather_f1(torch, workdir):
    """Phase 10 (a): the CLI on two graphs the kernels refuse, on the
    card."""
    import warnings

    import numpy as np

    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import GibbsEngine
    for name, src, flags, reason, n_rows in _f1_graphs(workdir):
        dst = os.path.join(workdir, "out_" + name)
        metrics.reset()
        launched = (pig.KERNEL_LAUNCHES, pig.LEARN_LAUNCHES)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ns = cli.main([src, *flags, "-o", dst, "-q", "--device", DEVICE,
                           "--engine", "itemgrid"])
        wall = time.perf_counter() - t0
        fg = ns.getFactorGraph()
        eng = fg.engine(True)
        said = [str(w.message) for w in caught
                if "unavailable for this graph" in str(w.message)]
        fallbacks = metrics.snapshot()["counters"].get("engine.fallbacks")
        paths = [os.path.join(dst, "inference_result.out" + s)
                 for s in (".text", ".weights.text")]
        if not all(os.path.isfile(p) for p in paths):
            fail("F1 %s: missing output files" % name)
        rows = np.loadtxt(paths[0], ndmin=2)
        weights = np.loadtxt(paths[1], ndmin=2)[:, 1]
        log("  (a) CLI %s %s --engine itemgrid: main() %.2f s, engine %s "
            "on %s, fallbacks %s, warning %r; %d marginal rows, mean %.4f, "
            "weights %s" % (name, " ".join(flags), wall, type(eng).__name__,
                            eng.device, fallbacks, said[0][:90] if said
                            else None, len(rows), rows[:, 2].mean(),
                            np.array2string(weights, precision=4)))
        if not isinstance(eng, GibbsEngine) or eng.device.type != "cuda" \
                or fg.state.count.device.type != "cuda":
            fail("F1 %s: not on the tensor-op engine on the card" % name)
        if fallbacks != 1 or len(said) != 1 or reason not in said[0]:
            fail("F1 %s: fallback not counted or warned once (%s, %s)"
                 % (name, fallbacks, said))
        if (pig.KERNEL_LAUNCHES, pig.LEARN_LAUNCHES) != launched:
            fail("F1 %s: a sweep or learn kernel launched" % name)
        if rows.shape != (n_rows, 3) or not np.isfinite(rows).all() or \
                not ((rows[:, 2] >= 0) & (rows[:, 2] <= 1)).all():
            fail("F1 %s: marginals malformed" % name)
        if name == "potts130" and weights[0] == 0.3:
            fail("F1 potts130: learning left the coupling at 0.3")
        del ns, fg, eng


def _row(row) -> dict:
    from numbskull_tpu_torch.experiments.micro_gather import HEADER
    return dict(zip(HEADER, row))


def gather_resources():
    """The gather kernels' registers and local memory per thread (spills
    and local arrays) as the loaded module reports them
    (cudaFuncGetAttributes): logged once; fails on any local memory."""
    from numbskull_tpu_torch.ops import gather as G
    lib = G._kernel_lib()
    out, spilled = [], []
    for which, name in enumerate(G.GATHER_KERNELS):
        regs, local = ctypes.c_int(), ctypes.c_int()
        rc = lib.nsx_gather_attrs(which, ctypes.byref(regs),
                                  ctypes.byref(local))
        if rc != 0:
            fail("cudaFuncGetAttributes of %s: CUDA error %d" % (name, rc))
        out.append("%s %d registers, %d B local" % (name, regs.value,
                                                    local.value))
        if local.value:
            spilled.append(name)
    log("    gather kernels: " + "; ".join(out))
    if spilled:
        fail("gather kernels spill to local memory: %s" % spilled)


def _gather_ragged(torch, dev):
    """Phase 10 (b): both kernels at ragged R (GATHER_RAGGED_R) on both
    paths, bit-equal to their plain versions; returns the largest
    difference of each kernel."""
    from numbskull_tpu_torch.ops import gather as G
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {"gather_sum": 0.0, "shifted_sum": 0.0}
    n = 0
    for R in GATHER_RAGGED_R:
        for ng, iters in GATHER_RAGGED:
            for form, span in (("gather_sum", 1), ("shifted_sum", 1),
                               ("shifted_sum", 8)):
                for nx in (R * span + 4096, GATHER_GLOBAL_NX + R * span):
                    plan = G.gather_plan(form, R, ng, span, iters, nx)
                    if plan.staged != (nx < GATHER_GLOBAL_NX):
                        fail("gather plan %s for nx %d" % (plan, nx))
                    x = torch.randint(0, 2, (nx,), generator=gen,
                                      device=dev, dtype=torch.float32)
                    if form == "gather_sum":
                        off = torch.randint(0, nx, (ng, R), generator=gen,
                                            device=dev, dtype=torch.int32)
                        got = G.gather_sum(x, off, iters)
                        want = G.gather_sum_reference(x, off, iters)
                    else:
                        sh = torch.randint(0, nx - R * span + 1, (ng,),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)
                        got = G.shifted_sum(x, sh, R, span, iters)
                        want = G.shifted_sum_reference(x, sh, R, span,
                                                       iters)
                    n += 1
                    if not torch.equal(got, want):
                        fail("%s R %d ng %d span %d iters %d nx %d (%s): "
                             "kernel differs from the plain version"
                             % (form, R, ng, span, iters, nx,
                                "staged" if plan.staged else "global"))
                    err[form] = max(err[form],
                                    float((got - want).abs().max()))
    log("  (b) ragged R %s, ng and iters %s, both paths: %d rows bit-equal "
        "to the plain versions" % (GATHER_RAGGED_R, GATHER_RAGGED, n))
    return err


def _gather_compare(torch):
    """Phase 10 (b): both gather kernels against their plain versions at
    the TPU scripts' shapes, at ragged R and at the sweep kernel's sizes,
    their registers, and the iters scaling. Returns {row name: row dict}
    of the sizes, and the largest difference of each kernel."""
    from numbskull_tpu_torch.benchutil import median_ms
    from numbskull_tpu_torch.experiments import micro_gather as mg
    from numbskull_tpu_torch.experiments import micro_gather2 as mg2
    from numbskull_tpu_torch.ops import gather as G
    dev = torch.device(DEVICE)
    gather_resources()
    t0 = time.perf_counter()
    rows = [_row(mg.run_mode(m, trw, it, ng, 8, dev, timed=False))
            for trw, it, ng in mg.VALIDATE for m in mg.MODES]
    rows += [_row(mg.run_mode(m, trw, it, ng, 8, dev, timed=False))
             for m, trw, it, ng in mg.TIMING]
    rows += [_row(mg2.run_mode(m, trw, it, ng, 64, dev, timed=False))
             for trw, it, ng in mg2.VALIDATE + mg2.TIMING
             for m in mg2.MODES]
    bad = [(r["mode"], r["trw"], r["ng"], r["iters"]) for r in rows
           if not r["ok"]]
    log("  (b) every TPU mode at the TPU scripts' shapes: %d of %d rows "
        "bit-equal to the plain version and the numpy formula (%.1f s)"
        % (len(rows) - len(bad), len(rows), time.perf_counter() - t0))
    if bad:
        fail("gather kernels differ from their plain versions: %s" % bad)
    err = _gather_ragged(torch, dev)
    for r in rows:
        form = r["gpu_form"].split()[0]
        err[form] = max(err[form], float(r["max_abs_err"]))

    # k doubles from 1000 while the call at k is short enough for the
    # host's share of a call to matter, and 2k iterations stay exact
    x, off, shift = mg.tpu_data(16, 16, 64)
    xt = torch.as_tensor(x, device=dev)
    offt = torch.as_tensor(off, device=dev)
    sh = torch.as_tensor(shift[:16], device=dev)
    for label, span, fn in (
            ("gather_sum", 1,
             lambda it: G.gather_sum(xt, offt, it, False)),
            ("shifted_sum span 8", 8, lambda it: G.shifted_sum(
                xt, sh, 1024, 8, it, False))):
        k = 1000
        t_k = median_ms(lambda: fn(k), dev)[0]
        while t_k < 1.0 and 4 * k * 16 * span < 1 << 24:
            k *= 2
            t_k = median_ms(lambda: fn(k), dev)[0]
        t_2k = median_ms(lambda: fn(2 * k), dev)[0]
        log("    iters scaling, %s at trw 16, ng 16: %.4f ms at %d, %.4f "
            "ms at %d: x%.3f" % (label, t_k, k, t_2k, 2 * k, t_2k / t_k))
        if not 1.8 <= t_2k / t_k <= 2.2:
            fail("%s: %d iterations take %.3fx the time of %d (want "
                 "1.8-2.2x): the iters loop does not run" % (
                     label, 2 * k, t_2k / t_k, k))

    sizes = {}
    for name, nx in mg.SWEEP_X:
        sizes[name] = _row(mg.sweep_gather_row(name, nx, mg.SWEEP_R,
                                               mg.SWEEP_NG, dev))
    sizes["sweep_span8"] = _row(mg2.sweep_shifted_row(
        "sweep_span8", mg2.SWEEP_NX, mg2.SWEEP_R, mg2.SWEEP_NG, mg2.SPAN,
        dev))
    for name, r in sizes.items():
        form = r["gpu_form"].split()[0]
        err[form] = max(err[form], float(r["max_abs_err"]))
        log("    %-11s %s, R %s, ng %s, x %s B: kernel %s ms (spread %s), "
            "plain %s, embedding_bag %s, bound %s (%s; %s of it), sector "
            "bound %s (%s of it), no-reuse time %s; equal %s" % (
                name, r["gpu_form"], r["R"], r["ng"], r["x_bytes"], r["ms"],
                r["spread_ms"], r["plain_ms"], r["library_ms"],
                r["bound_ms"], r["bound_by"], r["bound_share"],
                r["sector_bound_ms"], "-" if r["sector_bound_ms"] == "-"
                else "%.4f" % (float(r["sector_bound_ms"]) / float(r["ms"])),
                r["noreuse_ms"], r["ok"]))
        if not r["ok"]:
            fail("%s: kernel, plain version and embedding_bag differ"
                 % name)
        torch.cuda.empty_cache()
    return sizes, err


def _smoke_drivers(torch, workdir):
    """Phase 10 (c): the ten drivers at a smoke size, their TSVs
    checked. The gather kernels' launch counts are set to 0 just before
    and read just after."""
    from numbskull_tpu_torch.experiments import (
        common, degree_sweep, engine_tradeoff, gather_rates, hbm_scale,
        micro_gather, micro_gather2, micro_gather_xla, multiproc_scaling,
        profile_itemgrid, scaling)
    from numbskull_tpu_torch.ops import gather as G
    runs = (
        ("micro_gather", lambda p: micro_gather.run(
            p, DEVICE, timing=(("f32_row", 16, 200, 16),
                               ("roll", 16, 200, 16)),
            sweep_r=1 << 16, sweep_x=(("sweep_A", 1 << 20),
                                      ("sweep_B", 1 << 24)))),
        ("micro_gather2", lambda p: micro_gather2.run(
            p, DEVICE, timing=((16, 200, 16),), sweep_r=1 << 16,
            sweep_nx=1 << 24)),
        ("micro_gather_xla", lambda p: micro_gather_xla.run(
            p, 65536, 65536, 10, DEVICE)),
        ("degree_sweep", lambda p: degree_sweep.run(
            p, 12600, (1, 50), DEVICE, points=((4, 40), (2, 10)))),
        ("hbm_scale", lambda p: hbm_scale.run(p, ((160, 512),), DEVICE)),
        ("engine_tradeoff", lambda p: engine_tradeoff.run(
            p, DEVICE, scale=0.05, epochs=8)),
        ("profile_itemgrid", lambda p: profile_itemgrid.run(
            p, 256, 20, DEVICE, scale=0.05)),
        ("gather_rates", lambda p: gather_rates.run(
            p, DEVICE, sizes=(("sweep_A", 1 << 20), ("sweep_B", 1 << 24)),
            sweep_r=1 << 16, span_nx=1 << 24,
            timing=(("f32_row", 16, 200, 16), ("roll", 16, 200, 16)),
            timing2=((16, 200, 16),), calls=3)),
        ("scaling", lambda p: scaling.run(p, 128, DEVICE, points=(2, 10))),
        ("multiproc_scaling", lambda p: multiproc_scaling.run(
            p, 4096, 6, DEVICE, meshes=(2,), timeout=600)))
    G.GATHER_LAUNCHES = G.SHIFTED_LAUNCHES = 0
    for name, fn in runs:
        t0 = time.perf_counter()
        path = os.path.join(workdir, name + ".tsv")
        fn(path)
        first, header, rows = common.read_tsv(path)
        log("  (c) %-16s %d rows in %.1f s; %s" % (
            name, len(rows), time.perf_counter() - t0, first))
        if not first.startswith("# card: ") or not rows or \
                any(len(r) != len(header) for r in rows):
            fail("driver %s: malformed TSV" % name)
        if "ok" in header and not all(r["ok"] == "True" for r in rows):
            fail("driver %s: a row is not ok" % name)
        if "engine" in header and name == "degree_sweep" and \
                [r["engine"] for r in rows] != ["itemgrid", "itemgrid"]:
            fail("driver degree_sweep: engines %s"
                 % [r["engine"] for r in rows])
        if name == "engine_tradeoff" and any(
                r["itemgrid_ups"] == "fallback" for r in rows):
            fail("driver engine_tradeoff: a kernel engine fell back")
        if name == "multiproc_scaling" and [
                (r["engine"], r["nproc"]) for r in rows] != [
                ("sharded", "1"), ("sharded", "2"), ("bsp", "1")]:
            fail("driver multiproc_scaling: rows %s" % rows)
        if name == "profile_itemgrid" and not any(
                "itemgrid" in r["kernel"] or "sweep" in r["kernel"]
                for r in rows):
            fail("driver profile_itemgrid: no sweep kernel in the trace")
    launches = (G.GATHER_LAUNCHES, G.SHIFTED_LAUNCHES)
    log("  (c) gather kernels launched by the drivers: gather_sum %d, "
        "shifted_sum %d" % launches)
    if not all(launches):
        fail("a gather kernel never launched on the drivers' path")
    return launches


def phase_gather(torch, card):
    """Phase 10; returns what the kernels line needs."""
    log("== phase 10: graphs the kernels refuse, the gather kernels, the "
        "experiment drivers, %s" % card)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="nsx_chip_gather_") as work:
        _gather_f1(torch, work)
        sizes, err = _gather_compare(torch)
        launches = _smoke_drivers(torch, work)
    log("  phase 10 took %.1f s" % (time.perf_counter() - t0))
    return {"sizes": sizes, "err": err, "launches": launches}


def gather_records(g):
    """The kernels-line records of TPU kernels #10 and #11: per call at
    shape A (gather_sum) and at the span-8 shape (shifted_sum)."""
    recs = []
    for base, size, n in ((GATHER, "sweep_A", 0),
                          (SHIFTED, "sweep_span8", 1)):
        r = g["sizes"][size]
        recs.append(dict(base, launches=g["launches"][n],
                         max_abs_err=g["err"][base["name"]],
                         ms=float(r["ms"]), plain_ms=float(r["plain_ms"]),
                         bound_ms=float(r["bound_ms"]),
                         bound_by=r["bound_by"],
                         library_ms=float(r["library_ms"])))
    return recs


def _counts(pig):
    """The sweep, learn and has_ext sweep kernels' launch counts."""
    return (pig.KERNEL_LAUNCHES, pig.LEARN_LAUNCHES, pig.EXT_LAUNCHES)


def _zero_counts(pig):
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = pig.EXT_LAUNCHES = 0


def _outputs(out):
    """The bytes of a CLI run's two output files."""
    return [open(os.path.join(out, "inference_result.out" + s), "rb").read()
            for s in (".text", ".weights.text")]


def _cli_run(torch, argv):
    """main(argv) on the card with its counts set to 0 just before;
    returns (NumbSkull, wall s, launch counts, metrics snapshot)."""
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    metrics.reset()
    _zero_counts(pig)
    t0 = time.perf_counter()
    ns = cli.main(argv + ["-q", "--device", DEVICE])
    torch.cuda.synchronize()
    return ns, time.perf_counter() - t0, _counts(pig), metrics.snapshot()


def _ckpt_timing(snap) -> str:
    tm = snap["timings"]
    return ", ".join("%s %d x %.3f s" % (k, tm[k]["count"],
                                          tm[k]["total_s"] / tm[k]["count"])
                     for k in ("checkpoint.save_s", "checkpoint.load_s")
                     if k in tm)


def _ckpt_inference(torch, work, gdir, out):
    """Phase 11 (a): checkpointed inference through kernel #1 on the 1M
    Ising, whole and interrupted; (g) a trace around one more chunk."""
    import json as _json

    from numbskull_tpu_torch.observability import annotate, trace
    epochs, cut, chunk, burn = CKPT
    runs = {}
    for name, n, ck in (("whole", epochs, "ck_a"), ("cut", cut, "ck_b"),
                        ("resumed", epochs, "ck_b")):
        dst = os.path.join(work, "ck_out_" + name)
        ns, wall, launches, snap = _cli_run(torch, [
            gdir, "-i", str(n), "-b", str(burn), "-o", dst, "--checkpoint",
            os.path.join(work, ck), "--checkpoint_every", str(chunk)])
        fg = ns.factorGraphs[0]
        runs[name] = (fg, _outputs(dst), launches, snap["timings"])
        log("  (a) -i %d -b %d --checkpoint %s --checkpoint_every %d: "
            "main() %.2f s, launches %s, %s, resumes %s" % (
                n, burn, ck, chunk, wall, launches, _ckpt_timing(snap),
                snap["counters"].get("inference.resumes", 0)))
        colors = live_steps(fg.engine(True).tables)
        want = (n - (cut if name == "resumed" else 0) +
                (burn if name != "resumed" else 0)) * colors
        if launches != (want, 0, 0):
            fail("checkpointed inference (%s): launches %s, expected %s"
                 % (name, launches, (want, 0, 0)))
    whole, resumed = runs["whole"], runs["resumed"]
    same = whole[1] == resumed[1] and \
        torch.equal(whole[0].state.count, resumed[0].state.count)
    out["ckpt_bytes"] = os.path.getsize(os.path.join(work, "ck_a"))
    save, load = whole[3]["checkpoint.save_s"], \
        resumed[3]["checkpoint.load_s"]
    out["ckpt_save_s"] = save["total_s"] / save["count"]
    out["ckpt_load_s"] = load["total_s"] / load["count"]
    log("  (a) interrupted at %d and resumed == whole: %s (marginals file, "
        "tallies); checkpoint of %d variables: %d bytes, save %.4f s, "
        "load %.4f s" % (cut, same, whole[0].cg.n_vars, out["ckpt_bytes"],
                         out["ckpt_save_s"], out["ckpt_load_s"]))
    if not same:
        fail("checkpointed inference: the resumed run differs from the "
             "whole one")
    out["ckpt_marginals"] = whole[0].full_marginals(epochs)[:, 1]
    out["sweep_launches"] = whole[2][0]
    out["ising_fg"] = whole[0]

    # (g) the profiler around one more chunk of the same graph
    fg = whole[0]
    logdir = os.path.join(work, "trace")
    with trace(logdir), annotate("nsx.phase11"):
        fg.inference(0, chunk, sample_evidence=True,
                     checkpoint=os.path.join(work, "ck_trace"),
                     checkpoint_every=chunk)
    tfile = os.path.join(logdir, "trace.json")
    with open(tfile) as f:
        names = {str(e.get("name")) for e in _json.load(f)["traceEvents"]}
    kernels = sorted(n for n in names if any(k in n for k in SWEEP_KERNELS))
    log("  (g) trace of one chunk: %s, %d bytes, %d event names; "
        "nsx.chunk %s; sweep kernels %s" % (
            tfile, os.path.getsize(tfile), len(names), "nsx.chunk" in names,
            kernels))
    if "nsx.chunk" not in names or not kernels:
        fail("the trace lacks the nsx.chunk region or the sweep kernel")


def _ckpt_learning(torch, work, cdir, out):
    """Phase 11 (b): checkpointed learning through kernel #2 on the coin
    graph, whole and interrupted; (g) burnIn on the card."""
    from numbskull_tpu_torch.checkpoint import load_checkpoint
    from numbskull_tpu_torch.ops import itemgrid as pig
    epochs, cut, chunk, burn = CKPT
    runs = {}
    for name, n, ck in (("whole", epochs, "lk_a"), ("cut", cut, "lk_b"),
                        ("resumed", epochs, "lk_b")):
        dst = os.path.join(work, "lk_out_" + name)
        ns, wall, launches, snap = _cli_run(torch, [
            cdir, "-l", str(n), "-i", "5", "-b", "5", *CKPT_LEARN, "-o", dst,
            "--checkpoint", os.path.join(work, ck), "--checkpoint_every",
            str(chunk)])
        runs[name] = (ns, _outputs(dst), launches)
        log("  (b) -l %d -i 5 --checkpoint %s: main() %.2f s, launches %s, "
            "%s, resumes %s" % (n, ck, wall, launches, _ckpt_timing(snap),
                                snap["counters"].get("learning.resumes", 0)))
        per_epoch = learn_launches_per_epoch(
            ns.factorGraphs[0].engine(True).learn_tables())
        want = (n - (cut if name == "resumed" else 0)) * per_epoch
        if launches[1] != want:
            fail("checkpointed learning (%s): %d learn launches, expected "
                 "%d" % (name, launches[1], want))
    a = load_checkpoint(os.path.join(work, "lk_a.learn"), DEVICE)[0]
    b = load_checkpoint(os.path.join(work, "lk_b.learn"), DEVICE)[0]
    same = runs["whole"][1][1] == runs["resumed"][1][1] and all(
        _bits_equal(torch, getattr(a, k), getattr(b, k))
        for k in ("weight_value", "var_value", "var_value_evid"))
    w = runs["whole"][0].factorGraphs[0].getWeights()
    log("  (b) interrupted at %d and resumed == whole: %s (weights file, "
        "weights and both chains in <ck>.learn); weights %s" % (
            cut, same, w))
    if not same:
        fail("checkpointed learning: the resumed run differs")
    out["learn_launches"] = runs["whole"][2][1]
    out["coin_ns"] = runs["whole"][0]

    # (g) burnIn on the card: sweeps, no tally
    fg = runs["whole"][0].factorGraphs[0]
    cnt = fg.state.count.clone()
    _zero_counts(pig)
    fg.burnIn(3, True)
    colors = live_steps(fg.engine(True).tables)
    log("  (g) burnIn(3, True): %d sweep launches, tallies unchanged %s"
        % (pig.KERNEL_LAUNCHES, torch.equal(cnt, fg.state.count)))
    if pig.KERNEL_LAUNCHES != 3 * colors or \
            not torch.equal(cnt, fg.state.count):
        fail("burnIn did not run 3 untallied sweeps on the card")


def _ckpt_xla(torch, work, gdir, out):
    """Phase 11 (c): --engine xla on the 1M Ising, chunked == one call,
    marginals against (a)'s."""
    import numpy as np
    epochs, _, chunk, burn = CKPT
    runs = {}
    for name, flags in (("one call", []),
                        ("chunked", ["--checkpoint",
                                     os.path.join(work, "ck_x"),
                                     "--checkpoint_every", str(chunk)])):
        dst = os.path.join(work, "xla_" + name.replace(" ", "_"))
        ns, wall, launches, snap = _cli_run(torch, [
            gdir, "-i", str(epochs), "-b", str(burn), "-o", dst,
            "--engine", "xla", *flags])
        fg = ns.factorGraphs[0]
        ms = snap["timings"]["inference.sweep_s"]["total_s"] * 1e3 / (
            epochs + burn)
        runs[name] = (fg, _outputs(dst))
        log("  (c) --engine xla -i %d -b %d %s: main() %.2f s, %.3f ms per "
            "epoch (inference.sweep_s over %d epochs), launches %s, "
            "engine.requested.xla %s" % (
                epochs, burn, name, wall, ms, epochs + burn, launches,
                snap["counters"].get("engine.requested.xla")))
        if launches != (0, 0, 0):
            fail("--engine xla launched a kernel")
        out["xla_ms " + name] = ms
    one, chunked = runs["one call"], runs["chunked"]
    same = one[1] == chunked[1] and torch.equal(one[0].state.count,
                                                chunked[0].state.count)
    m = one[0].full_marginals(epochs)[:, 1]
    k = out["ckpt_marginals"]
    d_mean, d_abs = abs(m.mean() - k.mean()), float(np.abs(m - k).mean())
    log("  (c) chunked == one call: %s; against (a)'s kernels: mean "
        "marginal %.5f vs %.5f, mean |difference| %.4f (two independent "
        "120-epoch chains; 0.070 on a 128x128 Ising on the CPU)" % (
            same, m.mean(), k.mean(), d_abs))
    if not same:
        fail("--engine xla: the chunked run differs from the one call")
    if d_mean > 0.01 or d_abs > 0.1:
        fail("--engine xla marginals off the kernels' (mean %.5f, mean "
             "|difference| %.4f)" % (d_mean, d_abs))


def _ckpt_resilient(torch, work, coin):
    """Phase 11 (d): run_resilient on GibbsEngine with faults at chunks 1
    and 3 == the run without them."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import GibbsEngine
    from numbskull_tpu_torch.resilience import FaultInjector, run_resilient
    w, v, f, fm, dm, _ = coin
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      device=DEVICE)
    states = {}
    for name, hook in (("clean", None),
                       ("faults at 1, 3", FaultInjector(fail_at=(1, 3)))):
        metrics.reset()
        _zero_counts(pig)
        t0 = time.perf_counter()
        states[name] = run_resilient(
            eng, eng.init_state(), 7, epochs=120, chunk=30, burn=5,
            ckpt_path=os.path.join(work, "rs_" + name[:5]), fault_hook=hook)
        c = metrics.snapshot()["counters"]
        log("  (d) run_resilient %s: %.2f s, chunks %s, retries %s, "
            "launches %s" % (name, time.perf_counter() - t0,
                             c.get("resilience.chunks"),
                             c.get("resilience.retries", 0), _counts(pig)))
    a, b = states.values()
    same = torch.equal(a.count, b.count) and torch.equal(a.var_value,
                                                         b.var_value)
    log("  (d) with faults == without: %s" % same)
    if not same:
        fail("run_resilient: the run with faults differs")


def _ckpt_db(torch, work, coin, out):
    """Phase 11 (e): -u sqlite:// on the coin graph == loadFactorGraph
    on get_fg_data's arrays."""
    import sqlite3

    from numbskull_tpu_torch import dbsource
    from numbskull_tpu_torch import numbskull as cli
    w, v, f, fm, _, _ = coin
    db = os.path.join(work, "coin.db")
    t0 = time.perf_counter()
    conn = sqlite3.connect(db)
    dbsource.write_graph_to_db(conn.cursor(), "coin", w, v, f, fm)
    conn.commit()
    conn.close()
    log("  (e) write_graph_to_db: %d variables, %d factors, %d bytes in "
        "%.2f s" % (len(v), len(f), os.path.getsize(db),
                    time.perf_counter() - t0))
    argv = ["-l", "20", "-i", "20", "-b", "5", *CKPT_LEARN, "--seed", "4"]
    dst = os.path.join(work, "db_out")
    ns, wall, launches, snap = _cli_run(
        torch, ["-u", "sqlite://" + db, *argv, "-o", dst])
    out["db_load_s"] = snap["timings"]["load.db_s"]["total_s"]
    log("  (e) main -u: %.2f s, DB load %.3f s, compile %.3f s, launches "
        "%s" % (wall, out["db_load_s"],
                snap["timings"]["compile"]["total_s"], launches))
    if not launches[0] or not launches[1]:
        fail("-u: the sweep or learn kernel was not launched")
    conn = dbsource.connect("sqlite://" + db)
    arrays = dbsource.get_fg_data(conn.cursor())
    conn.close()
    ref = os.path.join(work, "db_ref")
    ns = cli.NumbSkull(n_learning_epoch=20, n_inference_epoch=20, burn_in=5,
                       stepsize=0.1, decay=0.99, reg_param=1e-4, seed=4,
                       quiet=True, device=DEVICE, output_dir=ref)
    ns.loadFactorGraph(*arrays[:6])
    ns.learning()
    ns.inference()
    same = _outputs(dst) == _outputs(ref)
    log("  (e) -u == loadFactorGraph(get_fg_data arrays): %s" % same)
    if not same:
        fail("-u output differs from the arrays' run")


def _ckpt_db_bsp(torch, work, coin):
    """Phase 11 (f): the keyed DB through run_distributed and
    bsp_from_db(itemgrid=True) (kernel #1 has_ext)."""
    import sqlite3

    import numpy as np

    from numbskull_tpu_torch import dbsource
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.parallel.bsp import BSPItemGridInference
    w, v, f, fm, _, _ = coin
    var_keys = ["B" if i % 2 == 0 else "D1" for i in range(len(v))]
    first_vid = fm["vid"][f["ftv_offset"].astype(np.int64)]
    factor_keys = ["Du1" if f["arity"][i] == 2 else
                   ("B" if first_vid[i] % 2 == 0 else "D1")
                   for i in range(len(f))]
    db = os.path.join(work, "keyed.db")
    t0 = time.perf_counter()
    conn = sqlite3.connect(db)
    dbsource.write_graph_to_db(conn.cursor(), "coin", w, v, f, fm,
                               var_keys=var_keys, factor_keys=factor_keys)
    conn.commit()
    conn.close()
    log("  (f) keyed graph written in %.2f s" % (time.perf_counter() - t0))
    ns = cli.load(["-u", "sqlite://" + db, "--parts", "2", "-i", "10", "-b",
                   "2", "-q", "-o", os.path.join(work, "keyed_out"),
                   "--device", DEVICE])
    t0 = time.perf_counter()
    res = cli.run_distributed(ns)
    log("  (f) --parts 2 -u: %.2f s; partition %s, mode %s, costs %s" % (
        time.perf_counter() - t0, res["partition"], res["mode"],
        res["costs"]))
    if "keys" not in res["costs"] or res["mode"] != "messages":
        fail("--parts -u: the DB keys were not costed or auto did not "
             "pick messages")
    conn = dbsource.connect("sqlite://" + db)
    cur = conn.cursor()
    t0 = time.perf_counter()
    eng, part, _ = dbsource.bsp_from_db(cur, itemgrid=True, seed=2,
                                        device=DEVICE)
    arrays = dbsource.get_fg_data(cur, "1=1", mark_roles=False)
    conn.close()
    ref = BSPItemGridInference(*arrays[:4], part, mode=eng.mode,
                               domain_mask=arrays[4], seed=2, device=DEVICE)
    log("  (f) bsp_from_db(itemgrid=True) and the arrays' engine built in "
        "%.2f s; mode %s, parts %s" % (
            time.perf_counter() - t0, eng.mode,
            np.bincount(part).tolist()))
    seed, burn, epochs = BSP_RUN
    _zero_counts(pig)
    eng.inference(seed, epochs, burn=burn)
    torch.cuda.synchronize()
    launches = _counts(pig)
    ref.inference(seed, epochs, burn=burn, plain=True)
    torch.cuda.synchronize()
    same = torch.equal(eng.state.values, ref.state.values) and \
        torch.equal(eng.state.counts, ref.state.counts)
    log("  (f) bsp_from_db kernels == the arrays' engine, plain versions "
        "(values, tallies): %s; launches %s" % (same, launches))
    if not same or not launches[2]:
        fail("bsp_from_db: the has_ext kernel did not run or disagrees")
    return launches[2]


def phase_checkpoint(torch, card):
    """Phase 11: checkpointed and resumable runs, --engine xla, the DB
    source, burnIn and the profiler hooks. Returns a dict of what it
    measured."""
    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch.models import coin_model, ising_grid
    from numbskull_tpu_torch.observability import device_memory_stats
    log("== phase 11: checkpoints, --engine xla, -u, burnIn, profiler; %s"
        % card)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    coin = coin_model(COIN_COPIES, *COIN_TRUTH, evidence=True, fixed=False,
                      seed=3)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_ckpt_") as work:
        gdir, cdir = (os.path.join(work, n) for n in ("ising", "coin"))
        t0 = time.perf_counter()
        w, v, f, fm, _, _ = ising_grid(GRID, GRID, weight=0.25)
        dataloading.write_factor_graph_files(gdir, w, v, f, fm)
        dataloading.write_factor_graph_files(cdir, *coin[:4])
        log("  Ising %dx%d and coin %d copies written in %.2f s" % (
            GRID, GRID, COIN_COPIES, time.perf_counter() - t0))
        _ckpt_inference(torch, work, gdir, out)
        _ckpt_learning(torch, work, cdir, out)
        _ckpt_xla(torch, work, gdir, out)
        _ckpt_resilient(torch, work, coin)
        _ckpt_db(torch, work, coin, out)
        out["ext_launches"] = _ckpt_db_bsp(torch, work, coin)
        stats = device_memory_stats()
        log("  (g) device_memory_stats: %s" % stats)
        if stats[0]["bytes_in_use"] <= 0:
            fail("device_memory_stats reports no bytes in use")
    log("  phase 11 took %.2f s" % (time.perf_counter() - t_phase))
    return out


def checkpoint_records(torch, r):
    """The `checkpoint` mode's kernels line: kernels #1 and #2 with phase
    11's main-path launches, each held against its plain version on
    phase 11's own tables and timed there (epoch-differenced)."""
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    eng = r["ising_fg"].engine(True)
    err = check_equal(torch, "ising1024 (phase 11)", "own", eng, burn=2,
                      epochs=3)
    infer = {w: rate(torch, eng, w == "plain", *pts)[1] for w, pts in
             (("plain", (2, 12)), ("kernel", (20, 220)))}
    sweep = dict(SWEEP, launches=r["sweep_launches"], max_abs_err=err,
                 ms=infer["kernel"], plain_ms=infer["plain"],
                 library_ms=None)
    sweep["bound_ms"], sweep["bound_by"] = bound(
        *sweep_epoch_cost(torch, eng.tables))
    leng = r["coin_ns"].factorGraphs[0].engine(True)
    lp = LearnParams(regularization=2, reg_param=1e-4)
    err_l = check_learn_equal(torch, "coin400k (phase 11)", leng, lp,
                              burn=2, epochs=3, stepsize=0.1, decay=0.99)
    learn = {w: rate(torch, leng, w == "plain", *pts, lp=lp)[1] for w, pts in
             (("plain", (2, 6)), ("kernel", (20, 120)))}
    lrec = dict(LEARN, launches=r["learn_launches"], max_abs_err=err_l,
                ms=learn["kernel"], plain_ms=learn["plain"], library_ms=None)
    lrec["bound_ms"], lrec["bound_by"] = bound(
        *learn_epoch_cost(torch, leng.learn_tables()))
    log("  phase 11 kernels: sweep %.4f ms (plain %.3f), learn %.4f ms "
        "(plain %.3f) per epoch" % (infer["kernel"], infer["plain"],
                                    learn["kernel"], learn["plain"]))
    return [sweep, lrec]


# phase 12: (seed, epochs, burn) of inference, (seed, epochs, stepsize,
# decay, burn) of learning; the in-process shapes beside (1, 1)
SHARDED_RUN = (5, 5, 2)
SHARDED_LEARN = (9, 2, 0.05, 0.99, 1)
SHARDED_SHAPES = ((1, 2), (1, 4), (2, 1), (2, 2))
# learning whose weights stay dyadic (summed integer gradients, a step of
# 2^-20, an L1 step of 2^-19 per truncation), so that any sum order of the
# shards' partials is exact: (seed, epochs, stepsize, decay, burn)
SHARDED_DYADIC = (13, 2, 2.0 ** -20, 1.0, 1)


def _sharded_lps():
    """Phase 12's L2 learning (phase 8's) and its dyadic L1 learning."""
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    return _mc_lp(), LearnParams(regularization=1, reg_param=1.0,
                                 truncation=2, grad_agg="sum")


def _sharded_runs(eng, leng):
    """Phase 12's three runs on a pair of mesh engines: inference on the
    Ising (``eng``), L2 and dyadic L1 learning on the learnable grid
    (``leng``)."""
    l2, l1 = _sharded_lps()
    st = eng.inference(eng.init_state(), *SHARDED_RUN)
    seed, epochs, step, decay, burn = SHARDED_LEARN
    ls = leng.learn(leng.init_state(), seed, epochs, step, decay, burn,
                    lp=l2)
    seed, epochs, step, decay, burn = SHARDED_DYADIC
    l1s = leng.learn(leng.init_state(), seed, epochs, step, decay, burn,
                     lp=l1)
    return st, ls, l1s


def _axis_sum_share(torch, eng, fn) -> float:
    """Share of ``fn()``'s wall time spent in the engine's two axis sums
    (the graph sum of partial potentials and gradients, the chains mean),
    each timed between two synchronizes."""
    spent = [0.0]

    def timed(f):
        def g(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(x)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return g
    eng._graph_sum = timed(eng._graph_sum)
    eng._chains_mean = timed(eng._chains_mean)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng._graph_sum, eng._chains_mean
    return spent[0] / wall


def _sharded_rates(torch, eng, leng):
    """(inference ms, learning ms) per epoch, epoch-differenced between
    fixed counts (1 and 4), and the axis sums' share of a 3-epoch
    inference and learning call."""
    from numbskull_tpu_torch.benchutil import epoch_rate
    st, ls = eng.init_state(), leng.init_state()
    lp = _mc_lp()
    kw = dict(reps=2, device=DEVICE, min_delta=0.0, max_epochs=4)
    inf = epoch_rate(lambda ep, r: eng.inference(st, 1 + r, ep), 1, 1, 4,
                     **kw)[1]
    lrn = epoch_rate(lambda ep, r: leng.learn(ls, 1 + r, ep, 0.05, lp=lp),
                     1, 1, 4, **kw)[1]
    share_i = _axis_sum_share(torch, eng, lambda: eng.inference(st, 2, 3))
    share_l = _axis_sum_share(torch, leng, lambda: leng.learn(
        ls, 2, 3, 0.05, lp=lp))
    return inf * 1e3, lrn * 1e3, share_i, share_l


def _chain_of(s, c) -> dict:
    """Chain c of a mesh state: its values, clamped values and tallies,
    and the weights."""
    return {"var_value": s.var_value[c], "var_value_evid":
            s.var_value_evid[c], "count": s.count[c],
            "weight_value": s.weight_value}


def _sharded_worker(rank, group, shape, out_dir):
    """One process of phase 12 (c): a ``global_mesh`` of ``shape`` on
    the card, phase 12's runs and rates; its state and numbers to
    ``out_dir``."""
    import torch
    from numbskull_tpu_torch.parallel import multihost
    from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine
    infer, lcg = _mc_graphs()
    eng = ShardedGibbsEngine(infer, multihost.global_mesh(*shape,
                                                          device=DEVICE))
    leng = ShardedGibbsEngine(lcg, multihost.global_mesh(*shape,
                                                         device=DEVICE))
    runs = _sharded_runs(eng, leng)
    marg = eng.marginals(runs[0], SHARDED_RUN[1])
    rates = _sharded_rates(torch, eng, leng)
    torch.save({"chains": eng.mesh.chains, "shards": eng.mesh.shards,
                "backend": torch.distributed.get_backend(group),
                "runs": [{k: v.cpu() for k, v in _chain_of(s, 0).items()}
                         for s in runs],
                "marg_mean": float(marg[:, 1].mean()), "rates": rates},
               os.path.join(out_dir, "rank%d.pt" % rank))


def phase_sharded(torch, card):
    """Phase 12: the (chains, graph) mesh engine (parallel/sharded) on
    the Ising 1024x1024 of phase 3 and, for learning, phase 8's
    learnable grid: (a) (1, 1) == GibbsEngine, (b) the in-process shapes
    against each other, (c) 4 gloo processes on the card == in-process
    (2, 2), a world of one nccl process == (a), (d) the rates. Returns
    the rates."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import GibbsEngine
    from numbskull_tpu_torch.parallel import multihost
    from numbskull_tpu_torch.parallel.mesh import make_mesh
    from numbskull_tpu_torch.parallel.sharded import (ShardedGibbsEngine,
                                                      chain_seed)
    import numpy as np
    log("== phase 12: the (chains, graph) mesh engine, Ising %dx%d; %s"
        % (GRID, GRID, card))
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    infer, lcg = _mc_graphs()
    log("  graphs compiled in %.2f s: %d variables, %d factors, %d colors"
        % (time.perf_counter() - t0, infer.n_vars, infer.n_factors,
           infer.n_colors))

    fields = ("var_value", "var_value_evid", "count", "weight_value")

    def same(a, b):
        return all(_bits_equal(torch, a[k].cpu(), b[k].cpu()) for k in a)

    # (a) (1, 1) against GibbsEngine seeded chain_seed(seed, 0)
    engines = {}
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    for shape in ((1, 1),) + SHARDED_SHAPES:
        t0 = time.perf_counter()
        eng = ShardedGibbsEngine(infer, make_mesh(*shape, device=DEVICE))
        leng = ShardedGibbsEngine(lcg, make_mesh(*shape, device=DEVICE))
        runs = _sharded_runs(eng, leng)
        torch.cuda.synchronize()
        engines[shape] = (eng, leng, runs)
        log("  %s built and run in %.2f s" % (shape,
                                             time.perf_counter() - t0))
    if pig.KERNEL_LAUNCHES or pig.LEARN_LAUNCHES:
        fail("the mesh engine launched an itemgrid kernel")
    g, gl = GibbsEngine(infer, device=DEVICE), GibbsEngine(lcg,
                                                           device=DEVICE)
    seed, epochs, burn = SHARDED_RUN
    refs = [{k: getattr(r, k) for k in fields} for r in (
        g.inference(g.init_state(), chain_seed(seed, c), epochs, burn=burn)
        for c in range(2))]
    seed, epochs, step, decay, burn = SHARDED_LEARN
    lref = gl.learn(gl.init_state(), chain_seed(seed, 0), epochs, step,
                    decay, burn, lp=_sharded_lps()[0])
    st, ls, _ = engines[(1, 1)][2]
    ok_a = same(_chain_of(st, 0), refs[0]) and \
        same(_chain_of(ls, 0), {k: getattr(lref, k) for k in fields})
    log("  (a) (1, 1) == GibbsEngine(chain_seed(seed, 0)): inference (%d "
        "burn-in + %d epochs: values, counts) and L2 learning (%d burn-in + "
        "%d epochs: weights %s, both chains): %s"
        % (SHARDED_RUN[2], SHARDED_RUN[1], SHARDED_LEARN[4],
           SHARDED_LEARN[1], ls.weight_value.tolist(), ok_a))
    if not ok_a:
        fail("the (1, 1) mesh differs from GibbsEngine")

    # (b) the in-process shapes against GibbsEngine and each other
    base = engines[(1, 1)][2]
    two = engines[(2, 1)][2]
    for shape in SHARDED_SHAPES:
        runs = engines[shape][2]
        ok = all(same(_chain_of(runs[0], c), refs[c])
                 for c in range(shape[0]))
        like = base if shape[0] == 1 else two
        ok_l = same(_chain_of(runs[2], 0), _chain_of(like[2], 0)) and \
            (shape[0] == 1 or same(_chain_of(runs[2], 1),
                                   _chain_of(like[2], 1)))
        ok_2 = shape[0] > 1 or same(_chain_of(runs[1], 0),
                                    _chain_of(base[1], 0))
        log("  (b) %s: inference chain c == GibbsEngine(chain_seed(seed, "
            "c)): %s; dyadic L1 "
            "learning == %s: %s (weights %s); L2 learning == (1, 1): %s"
            % (shape, ok, "(1, 1)" if shape[0] == 1 else "(2, 1)", ok_l,
               runs[2].weight_value.tolist(),
               ok_2 if shape[0] == 1 else "-"))
        if not (ok and ok_l and ok_2):
            fail("mesh shape %s differs from the unsharded forms"
                 % (shape,))
    marg = engines[(2, 2)][0].marginals(engines[(2, 2)][2][0],
                                        SHARDED_RUN[1])
    log("  (b) (2, 2) pooled marginals: shape %s, mean P(x=1) %.5f, "
        "finite %s" % (marg.shape, marg[:, 1].mean(),
                       bool(np.isfinite(marg).all())))
    if marg.shape != (infer.n_vars, infer.kmax) or \
            not np.isfinite(marg).all() or \
            not 0.3 < marg[:, 1].mean() < 0.7:
        fail("phase 12 marginals out of range")

    # (c) processes: 4 over gloo as (2, 2), one over nccl as (1, 1)
    ref22 = engines[(2, 2)][2]
    out = {}
    for backend, size, shape, want in (("gloo", 4, (2,), ref22),
                                       ("nccl", 1, (1,), base)):
        with tempfile.TemporaryDirectory(prefix="nsx_mesh_") as tmp:
            t0 = time.perf_counter()
            multihost.spawn(_sharded_worker, size, (shape, tmp),
                            backend=backend, timeout=600)
            wall = time.perf_counter() - t0
            res = [torch.load(os.path.join(tmp, "rank%d.pt" % r),
                              weights_only=False) for r in range(size)]
        ok = all(same(_chain_of(w, r["chains"][0]), got)
                 for r in res for got, w in zip(r["runs"], want))
        log("  (c) %d %s process%s as %s: backend %s, every rank's values, "
            "counts, L2 and L1 weights and both chains == in-process: %s; "
            "mean P(x=1) %.5f; spawn to exit %.1f s"
            % (size, backend, "es" if size > 1 else "",
               "(2, 2)" if size > 1 else "(1, 1)", res[0]["backend"], ok,
               res[0]["marg_mean"], wall))
        if not ok:
            fail("%s processes differ from the in-process mesh" % backend)
        out[(backend, size)] = res[0]["rates"]

    # (d) rates
    log("  (d) ms per epoch, epoch-differenced (1 and 4 epochs, best of "
        "2, CUDA events), and the axis sums' share of a 3-epoch call "
        "(synchronized around each sum); %s" % card)
    rates = {}
    for shape in ((1, 1),) + SHARDED_SHAPES:
        eng, leng, _ = engines[shape]
        rates[str(shape)] = _sharded_rates(torch, eng, leng)
    rates["(2, 2) 4 gloo processes"] = out[("gloo", 4)]
    rates["(1, 1) 1 nccl process"] = out[("nccl", 1)]
    for name, (inf, lrn, si, sl) in rates.items():
        log("  (d) %-26s inference %9.3f ms/epoch (sums %.3f), learning "
            "%9.3f ms/epoch (sums %.3f)" % (name, inf, si, lrn, sl))
    log("  phase 12 took %.2f s" % (time.perf_counter() - t_phase))
    return rates


# ---- phase 13: every factor function through kernels #1 and #2 ----------

FACTOR_KINDS = ("a14", "a13", "hub", "cat", "cat32", "cat128")
# the cardinalities of the categorical kinds, 3 to the top, which one
# variable of cat32 and cat128 takes: the three forms of the categorical
# kernels (KMAX 8, 32, 128), `cdf` draws at kmax <= 8 and `vec` above
CAT_CARDS = {"cat": 8, "cat32": 32, "cat128": 128}
# the arities golden.eval_factor reads for these codes; the others take
# any arity
FIXED_ARITY = {"DP_GEN_CLASS_PRIOR": 1, "DP_GEN_LF_PRIOR": 1,
               "DP_GEN_LF_PROPENSITY": 1, "DP_GEN_LF_ACCURACY": 2,
               "DP_GEN_LF_CLASS_PROPENSITY": 2, "DP_GEN_DEP_FIXING": 3,
               "DP_GEN_DEP_REINFORCING": 3, "DP_GEN_DEP_EXCLUSIVE": 2,
               "DP_GEN_DEP_SIMILAR": 2}
DYADIC = (-1.0, -0.75, -0.5, -0.25, -0.125, 0.125, 0.25, 0.5, 0.75, 1.0)
HUB_FACTORS = 1100       # items on the hub row: past ops/itemgrid.ITEM_TILE
SPOUSE_PAIRS = 1000      # phase 13 (f): spouse_shape's candidate pairs
# factors of a cat or cat32 graph on its wide row: more evaluations than
# the categorical learn kernel keeps for a row (ops/itemgrid.kept_terms),
# so that its step is re-read while the graph's other steps are kept; a
# code of arity 1 has one step (no variable neighbours another), which
# WIDE_VARS variables cut into two tiles, the wide row's and a kept one
WIDE_FACTORS = 20
WIDE_VARS = 160
DP_CANDIDATES = 200000   # phase 13 (d): PERF.md's LF cell, 10 LFs
DP_LFS = 10
DP_ARGV = ["-l", "20", "-i", "100", "-b", "10"]
POTTS_CAT = (256, 128)   # phase 13 (e): Potts side and cardinality
# Three times the spread (max - min) over seeds 0, 1, 2 of the class's
# mean marginal and of the learned weights (the largest over weights) of
# DP_ARGV on the DP graph, the larger of the two engines', as `python3
# chip_smoke.py dpspread` measured it on one H100 80GB HBM3 at 700 W
DP_TOL_MEAN = 3 * 0.001244
DP_TOL_WEIGHT = 3 * 0.000259


def random_graph(codes, kind, seed, n_vars=None, n_factors=None,
                 cards=None, dtype1=1 / 3, evidence=0.3, wide=0):
    """(weights, variables, factors, fmap) of a random graph whose
    factors take the codes ``codes`` (names of ``types.FACTORS``) in
    turn, with 4 dyadic weights (weight 0 fixed) and featureValue 1.
    ``kind``: 'a14' boolean, arity 1 to 4 (30 variables, 40 factors);
    'a13' boolean, arity 13 (30, 20); 'hub' boolean, arity 1 to 2, with
    variable 0, evidence, in each of HUB_FACTORS factors (40
    variables); 'cat', 'cat32', 'cat128' cardinality 3 to 8, 32, 128
    (CAT_CARDS; one variable at 32 or 128; ``cards`` (lo, hi) in its
    place), arity 1 to 4; given ``wide``, variable 0 takes the top
    cardinality and is the last argument of the first ``wide`` factors.
    Codes of FIXED_ARITY take theirs. A share ``dtype1`` of the
    variables is dataType 1 (an item applies at its slot values only),
    a share ``evidence`` is evidence. UFO's first argument has a
    cardinality of at most its arity + 1, so golden reads no position
    beyond the factor (the port clips there: a deviation ROADMAP
    lists)."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    n = n_vars or (40 if kind == "hub" else 30)
    nf = n_factors or {"hub": HUB_FACTORS, "a13": 20}.get(kind, 40)
    if kind in CAT_CARDS:
        lo, hi = cards or (3, CAT_CARDS[kind])
        card = rng.integers(lo, hi + 1, n)
        if kind != "cat":
            card[rng.integers(n)] = hi
        if wide:
            card[0] = hi
    else:
        card = np.full(n, 2)
    v = T.new_variables(n)
    v["cardinality"] = card
    v["dataType"] = rng.random(n) < dtype1
    v["isEvidence"] = rng.random(n) < evidence
    v["isEvidence"][0] |= kind == "hub"    # its items carry the gradient
    v["initialValue"] = rng.integers(0, 1 << 30, n) % card
    w = T.new_weights(4)
    w["initialValue"] = rng.choice(DYADIC, 4)
    w["isFixed"] = (True, False, False, False)
    arities, vids = [], []
    for i in range(nf):
        name = codes[i % len(codes)]
        a = FIXED_ARITY.get(name) or {
            "a13": 13, "hub": int(rng.integers(1, 3))}.get(
                kind, int(rng.integers(1, 5)))
        if name == "UFO":
            a = max(a, int(card.min()) - 1)
        vid = rng.integers(0, n, a)
        if name == "UFO":
            vid[0] = rng.choice(np.flatnonzero(card <= a + 1))
        if kind == "hub":
            vid[rng.integers(a)] = 0
        if i < wide:
            vid[-1] = 0
        arities.append(a)
        vids.append(vid)
    f = T.new_factors(nf)
    f["factorFunction"] = [T.FACTORS[codes[i % len(codes)]]
                           for i in range(nf)]
    f["weightId"] = rng.integers(0, 4, nf)
    f["featureValue"] = 1.0
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    fm = T.new_fmap(int(sum(arities)))
    fm["vid"] = np.concatenate(vids)
    fm["dense_equal_to"] = rng.integers(0, 1 << 30, len(fm)) % \
        card[fm["vid"]]
    return w, v, f, fm


def spouse_shape(pairs, seed, fv=None):
    """(weights, variables, factors, fmap) of DeepDive's spouse graph's
    shape at kmax 2: boolean candidates in pairs (a sentence's two
    orderings), each with 8 to 60 ISTRUE feature factors on 200
    learnable weights drawn Zipf-like, and the symmetry rule both ways
    (IMPLY on the fixed weight 0), 30 % evidence: rows of 10 to 62 items,
    whose runs of 128 rows hold some 4,500. ``fv(rng, n)`` draws the
    featureValues (default 1). The types are the port's, which the JAX
    package's equal field for field."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    n = 2 * pairs
    nfeat = rng.integers(8, 61, n)
    nf = int(nfeat.sum())
    v = T.new_variables(n)
    v["isEvidence"] = rng.random(n) < 0.3
    v["initialValue"] = rng.integers(0, 2, n)
    v["dataType"] = 0
    v["cardinality"] = 2
    w = T.new_weights(201)
    w["isFixed"] = np.arange(201) == 0
    w["initialValue"] = np.where(np.arange(201) == 0, 0.75, 0.0)
    f = T.new_factors(nf + n)
    f["factorFunction"] = np.where(np.arange(nf + n) < nf, T.FUNC_ISTRUE,
                                   T.FUNC_IMPLY_NATURAL)
    f["weightId"] = np.concatenate((np.minimum(rng.zipf(1.5, nf), 200),
                                    np.zeros(n, np.int64)))
    f["featureValue"] = 1.0 if fv is None else fv(rng, nf + n)
    f["arity"] = np.where(np.arange(nf + n) < nf, 1, 2)
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(f["arity"])[:-1]))
    fm = T.new_fmap(nf + 2 * n)
    fm["vid"][:nf] = np.repeat(np.arange(n), nfeat)
    fm["vid"][nf::2] = np.arange(n)          # candidate i implies
    fm["vid"][nf + 1::2] = np.arange(n) ^ 1  # its reverse
    return w, v, f, fm


def dp_graph(candidates, n_lf, seed):
    """(weights, variables, factors, fmap) of a data-programming
    generative model: per candidate a latent boolean class y (query) and
    n_lf labeling-function outputs (cardinality 3, 2 = abstain,
    evidence) drawn from per-LF propensities and accuracies; per
    candidate DP_GEN_CLASS_PRIOR(y) and, for each LF, LF_ACCURACY(y, l),
    LF_PROPENSITY(l), LF_CLASS_PROPENSITY(y, l) and LF_PRIOR(l); then
    DEP_FIXING(y, l_a, l_b), DEP_REINFORCING(y, l_a, l_b),
    DEP_EXCLUSIVE(l_a, l_b) and DEP_SIMILAR(l_a, l_b) on the LF pairs
    (0, 1), (2, 3), (4, 5), (6, 7) (indices mod n_lf). One weight per
    (factor kind, LF): accuracies start at 1.0 (which breaks the y ->
    1 - y symmetry), the rest at dyadic values in [-0.5, 0.5]. Factors
    are written kind by kind, so that equal arities run together."""
    import numpy as np

    from numbskull_tpu_torch import types as T
    rng = np.random.default_rng(seed)
    C, L = candidates, n_lf
    y = rng.integers(0, 2, C)
    prop = rng.uniform(0.3, 0.9, L)
    acc = rng.uniform(0.6, 0.9, L)
    fires = rng.random((C, L)) < prop
    right = rng.random((C, L)) < acc
    lab = np.where(fires, np.where(right, y[:, None], 1 - y[:, None]), 2)
    n = C * (1 + L)
    v = T.new_variables(n)
    yv = np.arange(C) * (1 + L)
    lv = yv[:, None] + 1 + np.arange(L)
    v["cardinality"] = 3
    v["cardinality"][yv] = 2
    v["isEvidence"] = 1
    v["isEvidence"][yv] = 0
    v["initialValue"][lv.ravel()] = lab.ravel()
    pairs = [((2 * k) % L, (2 * k + 1) % L) for k in range(4)]
    nw = 1 + 4 * L + 4
    w = T.new_weights(nw)
    w["initialValue"] = rng.choice(DYADIC, nw) / 2
    w["initialValue"][1:1 + L] = 1.0
    kinds = [("DP_GEN_CLASS_PRIOR", [yv], np.zeros(1, int))]
    for k, name in enumerate(("DP_GEN_LF_ACCURACY", "DP_GEN_LF_PROPENSITY",
                              "DP_GEN_LF_CLASS_PROPENSITY",
                              "DP_GEN_LF_PRIOR")):
        two = name in ("DP_GEN_LF_ACCURACY", "DP_GEN_LF_CLASS_PROPENSITY")
        args = [np.repeat(yv, L), lv.ravel()] if two else [lv.ravel()]
        kinds.append((name, args, np.tile(1 + k * L + np.arange(L), C)))
    for k, (name, (a, b)) in enumerate(zip(
            ("DP_GEN_DEP_FIXING", "DP_GEN_DEP_REINFORCING",
             "DP_GEN_DEP_EXCLUSIVE", "DP_GEN_DEP_SIMILAR"), pairs)):
        args = [lv[:, a], lv[:, b]]
        if FIXED_ARITY[name] == 3:
            args = [yv] + args
        kinds.append((name, args, np.full(C, 1 + 4 * L + k)))
    nf = sum(len(a[0]) for _, a, _ in kinds)
    f = T.new_factors(nf)
    fm = T.new_fmap(sum(len(a[0]) * len(a) for _, a, _ in kinds))
    i = e = 0
    for name, args, wid in kinds:
        m, a = len(args[0]), len(args)
        f["factorFunction"][i:i + m] = T.FACTORS[name]
        f["weightId"][i:i + m] = np.broadcast_to(wid, (m,))
        f["arity"][i:i + m] = a
        f["ftv_offset"][i:i + m] = e + a * np.arange(m)
        fm["vid"][e:e + a * m] = np.stack(args, axis=1).ravel()
        i, e = i + m, e + a * m
    f["featureValue"] = 1.0
    return w, v, f, fm


def factor_fixtures_of(name, kinds=FACTOR_KINDS):
    """Phase 13 (a)'s graphs of factor code ``name`` alone: (graph name,
    (name,), (w, v, f, fm)) in every kind of ``kinds`` that takes it (a13
    only where the arity is free), each from its own seed; cat and cat32
    with a wide row (WIDE_FACTORS; WIDE_VARS variables at arity 1)."""
    from numbskull_tpu_torch import types as T
    i = list(T.FACTORS).index(name)
    wide = {"cat": WIDE_FACTORS, "cat32": WIDE_FACTORS}
    n_vars = WIDE_VARS if FIXED_ARITY.get(name) == 1 else None
    return [("%s/%s" % (name, kind), (name,),
             random_graph((name,), kind, 1000 + 10 * i + j,
                          n_vars=n_vars if kind in wide else None,
                          wide=wide.get(kind, 0)))
            for j, kind in enumerate(FACTOR_KINDS)
            if kind in kinds and not (kind == "a13" and name in FIXED_ARITY)]


def factor_fixtures():
    """Phase 13 (a)'s graphs: every code alone (factor_fixtures_of) in
    the kinds a14, a13, hub and cat, then the three mixed graphs: every
    code on boolean variables (arity as the code takes it, 1 to 4
    otherwise), every code at cardinality 3 to 8, and the DP model with
    card-3 LF variables; then every code alone at cat32 and cat128."""
    from numbskull_tpu_torch import types as T
    out = [g for name in T.FACTORS
           for g in factor_fixtures_of(name, FACTOR_KINDS[:4])]
    codes = tuple(T.FACTORS)
    out.append(("mixed/bool", codes,
                random_graph(codes, "a14", 7, n_vars=60, n_factors=150)))
    out.append(("mixed/cat", codes,
                random_graph(codes, "cat", 8, n_vars=60, n_factors=150)))
    dp = tuple(n for n in codes if n.startswith("DP_"))
    out.append(("mixed/dp", dp, dp_graph(12, DP_LFS, 9)))
    return out + [g for name in T.FACTORS
                  for g in factor_fixtures_of(name, FACTOR_KINDS[4:])]


def exact_fixtures():
    """Phase 13 (c)'s graphs, small enough to enumerate, every variable
    dataType 0 and free: boolean (10 variables, every code), categorical
    (5 variables of cardinality 3, every code) and the DP model (2
    candidates, 3 LFs; 2,916 states) at half its weights, so that its
    chain mixes within 20,000 epochs."""
    from numbskull_tpu_torch import types as T
    codes = tuple(T.FACTORS)
    dp = dp_graph(2, 3, 23)
    dp[0]["initialValue"] /= 2
    return [("exact/bool", random_graph(codes, "a14", 21, n_vars=10,
                                        n_factors=14, dtype1=0)),
            ("exact/cat", random_graph(codes, "cat", 22, n_vars=5,
                                       n_factors=10, cards=(3, 3),
                                       dtype1=0)),
            ("exact/dp", dp)]


def _step_codes(t, ci):
    """The factor codes of step ``ci``'s items in tables ``t``."""
    import numpy as np
    return np.unique(np.asarray(t.plans[ci].it_ftype)[
        t.item_index[ci]]).tolist()


def sweep_paths(t):
    """{factor code: {sweep path}} of sweep tables ``t``: per step with
    rows, ('item', lanes, fast) at kmax 2, ('cat', KMAX template)
    above (the choice of nsx_itemgrid_sweep_color)."""
    out = {}
    for ci in range(t.n_steps):
        if t.n_rows[ci] == 0:
            continue
        if t.kmax <= 2:
            _, lanes, fast = t.item_shape[ci]
            path = ("item", lanes, bool(fast))
        else:
            path = ("cat", next(k for k in (8, 32, 128) if t.kmax <= k))
        for c in _step_codes(t, ci):
            out.setdefault(c, set()).add(path)
    return out


def learn_paths(lt):
    """{factor code: {learn step kernel}} of learn tables ``lt``: the
    kernel of the form the tables record for each tile holding the code
    (``tl_form``): learn_item_kernel, learn_step_kernel (`row`),
    learn_kept_kernel<KMAX> or learn_cat_kernel<KMAX>."""
    import numpy as np

    from numbskull_tpu_torch.ops.itemgrid import LEARN_FORMS
    t = lt.sweep
    k = next(k for k in (8, 32, 128) if t.kmax <= k)
    names = {"item": "learn_item", "row": "learn_step",
             "kept": "learn_kept<%d>" % k, "cat": "learn_cat<%d>" % k}
    out = {}
    for ci in range(t.n_steps):
        if t.n_rows[ci] == 0:
            continue
        o = lt.host[ci]
        ftype = np.asarray(t.plans[ci].it_ftype)[t.item_index[ci]]
        ri = t.row_item[t.row0[ci]:t.row0[ci] + t.n_rows[ci] + 1].cpu()
        ri = (ri - ri[0]).numpy()[np.append(o["tl_r0"], t.n_rows[ci])]
        for a, b, form in zip(ri[:-1], ri[1:], o["tl_form"]):
            for c in np.unique(ftype[a:b]).tolist():
                out.setdefault(c, set()).add(names[LEARN_FORMS[form]])
    return out


def required_paths(name):
    """(sweep, learn) requirements of factor code ``name``: labels and
    tests on a sweep path of sweep_paths, and the learn kernels. Every
    code runs the categorical kernel at KMAX 8, 32 and 128 and every
    learn kernel (at KMAX 2 learn_step_kernel on the hub graph's
    HUB_FACTORS-item row, a tile of its own past ITEM_TILE, and
    learn_item_kernel on the other steps); in the item kernel, a code of
    free arity runs 1 lane, 2 to 4 and 8 or more lanes an item (FAST
    for ops/itemgrid.FAST_TYPES, and not FAST in the mixed graph), a code
    of fixed arity the lanes its arity gives; both categorical learn
    kernels at KMAX 8 and 32 (the cat and cat32 graphs' wide rows,
    WIDE_FACTORS), the re-read one at 128 (a row at card 128 is too wide
    to keep; phase 2's kept_mixed graphs keep rows at KMAX 128)."""
    from numbskull_tpu_torch import types as T
    from numbskull_tpu_torch.ops.itemgrid import FAST_TYPES, sweep_lanes
    need = [("cat<%d>" % k, lambda p, k=k: p == ("cat", k))
            for k in (8, 32, 128)]
    fast = T.FACTORS[name] in FAST_TYPES
    if name in FIXED_ARITY:
        lanes = sweep_lanes(1, FIXED_ARITY[name])
        need.append(("item L%d" % lanes,
                     lambda p: p[0] == "item" and p[1] == lanes))
    else:
        for label, ok in (("L1", lambda n: n == 1),
                          ("L2-4", lambda n: 2 <= n <= 4),
                          ("L8+", lambda n: n >= 8)):
            need.append(("item %s%s" % (label, " FAST" if fast else ""),
                         lambda p, ok=ok: p[0] == "item" and ok(p[1]) and
                         p[2] == fast))
        if fast:
            need.append(("item not FAST",
                         lambda p: p[0] == "item" and not p[2]))
    return need, ("learn_item", "learn_step", "learn_cat<8>",
                  "learn_kept<8>", "learn_cat<32>", "learn_kept<32>",
                  "learn_cat<128>")


def _potentials_vs_golden(torch, cg, model, seed):
    """Largest |ops/gibbs.color_potentials - golden.potential| / max(1,
    |golden.potential|) over every (variable, value below its
    cardinality) at a random state, on the card: a float32 sum against
    a float64 one (a hub row's 1,100 RATIO terms come to about 65, and
    their float32 sum is 9e-5 off)."""
    import numpy as np

    from numbskull_tpu_torch import golden
    from numbskull_tpu_torch.ops.gibbs import color_potentials, plan_tensors
    from numbskull_tpu_torch.ops.itemgrid import present_types_of
    w, v, f, fm = model
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 30, len(v)) % v["cardinality"]
    wv = w["initialValue"].astype(np.float32)
    xt = torch.as_tensor(x.astype(np.int32), device=DEVICE)
    wt = torch.as_tensor(wv, device=DEVICE)
    worst = 0.0
    for p in cg.plans:
        pot = color_potentials(plan_tensors(p, DEVICE), p.kmax,
                               present_types_of(p.it_ftype), xt,
                               wt).cpu().numpy()
        for r, vid in enumerate(p.cv_vid[p.cv_valid]):
            for k in range(int(v["cardinality"][vid])):
                want = golden.potential(v, f, fm, wv, int(vid), k, x)
                worst = max(worst, abs(float(pot[r, k]) - want) /
                            max(1.0, abs(want)))
    return worst


FACTOR_LPS = (("L2", dict(regularization=2, reg_param=0.01)),
              ("L1 non-evidence", dict(regularization=1, reg_param=0.01,
                                       truncation=2,
                                       learn_non_evidence=True)),
              ("sum", dict(regularization=2, reg_param=0.01,
                           grad_agg="sum")))


def _phase13_compare(torch, fixtures, swept, learned):
    """Phase 13 (a) and (b) on ``fixtures`` (factor_fixtures), 1
    burn-in and 2 epochs a comparison; fills ``swept`` and ``learned``
    ({code: paths}); returns (largest kernel-vs-plain difference,
    largest relative |plain - golden| potential, seconds of (a), of its
    learning, of (b))."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    worst = gworst = 0.0
    t_a = t_b = t_l = 0.0
    by_kind = {}
    for gi, (name, codes, model) in enumerate(fixtures):
        t0 = time.perf_counter()
        w, v, f, fm = model
        cg = compile_graph(w, v, f, fm)
        mixed = name.startswith("mixed/")
        scheds = _every_map_and_draw(pig.default_schedule(cg))
        if mixed:
            scheds = [s for s in scheds if s[0] in GROUP_SCHEDULES]
        eng = pig.ItemGridEngine(cg, sample_evidence=not mixed,
                                 device=DEVICE)
        tables = eng.tables
        for label, sched in scheds:
            # the same tables under another map and draw on every step
            eng.tables = dataclasses.replace(
                tables, map_codes=[pig.MAPS.index(m) for m in sched.maps],
                draw_codes=[pig.DRAWS.index(d) for d in sched.draws])
            worst = max(worst, check_equal(torch, name, label, eng, seed=gi,
                                           burn=1, epochs=2))
            for c, ps in sweep_paths(eng.tables).items():
                swept.setdefault(c, set()).update(ps)
        eng = pig.ItemGridEngine(cg, device=DEVICE)
        kind = name.split("/")[0 if mixed else 1]
        # L2 alone on the hub, a13, cat32 and cat128 graphs, whose plain
        # versions take the longest (a 1,100-item row, 20 and more
        # colors, 128 candidates); the settings differ in the weight
        # update, which no graph kind changes
        lps = FACTOR_LPS[:1] if kind in ("hub", "a13", "cat32", "cat128") \
            else FACTOR_LPS
        t_l -= time.perf_counter()
        for label, lpk in lps:
            worst = max(worst, check_learn_equal(
                torch, "%s %s" % (name, label), eng, LearnParams(**lpk),
                moves=codes != ("NOOP",), seed=gi, burn=1, epochs=2))
        for c, ps in learn_paths(eng.learn_tables()).items():
            learned.setdefault(c, set()).update(ps)
        t1 = time.perf_counter()
        t_l += t1
        err = _potentials_vs_golden(torch, cg, model, gi)
        t_b += time.perf_counter() - t1
        t_a += t1 - t0
        by_kind[kind] = by_kind.get(kind, 0.0) + t1 - t0
        if not err <= 1e-4:
            fail("plain potentials off golden.potential by %g (relative "
                 "above 1) on %s" % (err, name))
        gworst = max(gworst, err)
    log("  (a) seconds by graph kind: " + ", ".join(
        "%s %.1f" % kv for kv in by_kind.items()))
    return worst, gworst, t_a, t_l, t_b


def _phase13_coverage(swept, learned):
    """Log each code's sweep paths and learn templates; fail unless every
    code ran every path that takes it (required_paths)."""
    from numbskull_tpu_torch import types as T
    for name, code in T.FACTORS.items():
        ps = swept.get(code, set())
        ls = learned.get(code, set())
        log("  %-27s sweep: %s; learn: %s" % (name, ", ".join(
            "item L%d%s" % (p[1], " FAST" if p[2] else "")
            if p[0] == "item" else "cat<%d>" % p[1] for p in sorted(ps)),
            ", ".join(sorted(ls))))
        need, need_l = required_paths(name)
        missing = [label for label, ok in need if not any(map(ok, ps))]
        missing += [t for t in need_l if t not in ls]
        if missing:
            fail("factor %s did not run %s" % (name, ", ".join(missing)))


def _phase13_exact(torch):
    """Phase 13 (c): the kernel's marginals over 20,000 epochs against
    golden.exact_marginals; returns the largest difference."""
    import numpy as np

    from numbskull_tpu_torch import golden
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops import itemgrid as pig
    epochs, worst = 20000, 0.0
    for name, (w, v, f, fm) in exact_fixtures():
        t0 = time.perf_counter()
        exact = golden.exact_marginals(v, f, fm, w["initialValue"])
        t1 = time.perf_counter()
        eng = pig.ItemGridEngine(compile_graph(w, v, f, fm), device=DEVICE)
        _, counts = eng.run(seed=31, burn=200, epochs=epochs)
        marg = counts.cpu().numpy().astype(np.float64) / epochs
        card = v["cardinality"]
        mask = np.arange(marg.shape[1])[None, :] < card[:, None]
        err = float(np.abs(marg - exact[:, :marg.shape[1]])[mask].max())
        log("  %-10s %d variables, %d factors: kernel marginals over %d "
            "epochs vs exact, max |diff| %.4f (enumeration %.2f s, run "
            "%.2f s)" % (name, len(v), len(f), epochs, err, t1 - t0,
                         time.perf_counter() - t1))
        if not err <= 0.02:
            fail("kernel marginals off the exact ones by %.4f on %s"
                 % (err, name))
        worst = max(worst, err)
    return worst


def _dp_write(work, candidates, seed=5):
    """The DP graph of phase 13 (d) as DeepDive files under ``work``;
    returns (directory, variables, factors, build s, write s)."""
    from numbskull_tpu_torch import dataloading
    t0 = time.perf_counter()
    w, v, f, fm = dp_graph(candidates, DP_LFS, seed)
    t1 = time.perf_counter()
    gdir = os.path.join(work, "dp")
    dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    return gdir, len(v), len(f), t1 - t0, time.perf_counter() - t1


def _dp_cli(torch, gdir, work, engine, seed):
    """The CLI (DP_ARGV) on the DP graph under ``engine`` with the counts
    set to 0 just before; checks its outputs and returns a dict: the
    NumbSkull, wall seconds, launch counts, metrics snapshot, the class
    variables' mean marginal and the learned weights."""
    import numpy as np
    out = os.path.join(work, "dp_out_%s_%d" % (engine, seed))
    ns, wall, counts, snap = _cli_run(torch, [
        gdir, *DP_ARGV, "--engine", engine, "--seed", str(seed), "-o", out,
        "--plan_cache", os.path.join(work, "plans")])
    fg = ns.factorGraphs[0]
    card = np.asarray(fg.cg.var_card)
    with open(os.path.join(out, "inference_result.out.text"), "rb") as fh:
        lines = fh.read().count(b"\n")
    want = int(np.where(card == 2, 1, card).sum())
    if lines != want:
        fail("DP %s: %d marginal lines, expected %d" % (engine, lines, want))
    weights = np.loadtxt(os.path.join(
        out, "inference_result.out.weights.text"), ndmin=2)[:, 1]
    cnt = fg.state.count[torch.as_tensor(np.flatnonzero(card == 2),
                                         device=fg.state.count.device), 1]
    mean = float(cnt.double().mean()) / int(DP_ARGV[3])
    if not (np.isfinite(weights).all() and 0 < mean < 1):
        fail("DP %s: weights not finite or class mean %.4f" % (engine,
                                                                mean))
    return dict(ns=ns, wall=wall, counts=counts, snap=snap, mean=mean,
                weights=weights)


def _dp_timing(r) -> str:
    tm = r["snap"]["timings"]
    return ", ".join("%s %.3f" % (k, tm[k]["total_s"]) for k in (
        "load.files_s", "compile", "state_init", "itemgrid.build",
        "itemgrid.learn_tables", "learning.sweep_s", "inference.sweep_s",
        "dump.weights_s", "dump.marginals_s") if k in tm)


def _phase13_dp(torch, work, card):
    """Phase 13 (d): the DP graph through the CLI on the kernels
    (--engine itemgrid; a refusal fails) and on the tensor-op engine
    (--engine xla), class mean marginal and weights within DP_TOL_*;
    the kernels held against the plain versions on the CLI's tables;
    epoch-differenced ms of kernel and plain version. Returns what the
    kernels line reads."""
    import numpy as np

    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import GibbsEngine, LearnParams
    gdir, nv, nf, t_build, t_write = _dp_write(work, DP_CANDIDATES)
    log("  (d) DP graph: %d candidates x %d LFs, %d variables, %d "
        "factors; built in %.2f s, written in %.2f s"
        % (DP_CANDIDATES, DP_LFS, nv, nf, t_build, t_write))
    k = _dp_cli(torch, gdir, work, "itemgrid", 0)
    fg = k["ns"].factorGraphs[0]
    eng = fg.engine(True)
    if not isinstance(eng, pig.ItemGridEngine) or \
            k["snap"]["counters"].get("engine.fallbacks"):
        fail("DP graph: --engine itemgrid did not run on the kernels")
    lt = eng.learn_tables()
    n_colors = live_steps(eng.tables)
    lrn, inf, burn = (int(DP_ARGV[i]) for i in (1, 3, 5))
    sweeps, learns, _ = k["counts"]
    log("  itemgrid: main() %.2f s (%s); %d sweep and %d learn launches, "
        "%d colors, kmax %d; %s" % (k["wall"], _dp_timing(k), sweeps,
                                    learns, n_colors, eng.cg.kmax, card))
    if sweeps != (2 * burn + inf) * n_colors or \
            learns != lrn * learn_launches_per_epoch(lt):
        fail("DP graph: launches %d, %d, expected %d, %d"
             % (sweeps, learns, (2 * burn + inf) * n_colors,
                lrn * learn_launches_per_epoch(lt)))
    x = _dp_cli(torch, gdir, work, "xla", 0)
    if not isinstance(x["ns"].factorGraphs[0].engine(True), GibbsEngine) \
            or any(x["counts"]):
        fail("DP graph: --engine xla launched a kernel")
    log("  xla: main() %.2f s (%s); %s" % (x["wall"], _dp_timing(x), card))
    d_mean = abs(k["mean"] - x["mean"])
    d_w = float(np.abs(k["weights"] - x["weights"]).max())
    log("  class mean marginal itemgrid %.5f, xla %.5f (|diff| %.5f, "
        "tolerance %.5f); weights max |diff| %.5f (tolerance %.5f), "
        "itemgrid %s" % (k["mean"], x["mean"], d_mean, DP_TOL_MEAN, d_w,
                         DP_TOL_WEIGHT, np.array2string(
                             k["weights"], precision=4)))
    if not (d_mean <= DP_TOL_MEAN and d_w <= DP_TOL_WEIGHT):
        fail("DP graph: itemgrid and xla disagree beyond the tolerance")
    del x
    lp = LearnParams()
    err = max(check_equal(torch, "dp (CLI tables)", "own", eng, burn=1,
                          epochs=1),
              check_learn_equal(torch, "dp (CLI tables)", eng, lp, burn=1,
                                epochs=1))
    rates = {}
    for which in ("kernel", "plain"):
        plain = which == "plain"
        for mode, pts, lpx in (("infer", (2, 6) if plain else (5, 25),
                                None),
                               ("learn", (1, 3) if plain else (2, 10), lp)):
            ups, ms = rate(torch, eng, plain, *pts, lp=lpx)
            rates[(mode, which)] = ms
            log("  dp %s %-6s %.4f ms/epoch, %.6g variable updates/s "
                "(epochs %d..%d); %s" % (mode, which, ms, ups, *pts, card))
    return dict(sweeps=sweeps, learns=learns, err=err, rates=rates,
                sweep_cost=sweep_epoch_cost(torch, eng.tables),
                learn_cost=learn_epoch_cost(torch, lt))


def _phase13_potts(torch, card):
    """Phase 13 (e): Potts POTTS_CAT (256x256 at cardinality 128: the
    categorical kernels at KMAX 128) with 30 % evidence and a learnable
    weight: ``ItemGridEngine.run`` (2 burn-in + 10 epochs) and ``.learn``
    (1 + 5), each with the launch counts set to 0 just before and read
    just after; the kernels held to the plain versions on its tables;
    epoch-differenced ms of kernel and plain version. Returns what the
    kernels line reads."""
    import numpy as np

    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import ising_color_hint, potts_grid
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    side, k = POTTS_CAT
    w, v, f, fm, dm, _ = _with_evidence(potts_grid(
        side, side, card=k, weight=0.25, fixed=False), 0.3, 7)
    eng = pig.ItemGridEngine(compile_graph(
        w, v, f, fm, domain_mask=dm, color_hint=ising_color_hint(side, side)),
        device=DEVICE)
    lp = LearnParams(regularization=2, reg_param=1e-4)
    steps = live_steps(eng.tables)
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    _, counts = eng.run(3, 2, 10)
    torch.cuda.synchronize()
    sweeps = pig.KERNEL_LAUNCHES
    pig.KERNEL_LAUNCHES = pig.LEARN_LAUNCHES = 0
    wl, _, _ = eng.learn(3, 1, 5, 0.05, 0.99, lp)
    torch.cuda.synchronize()
    learns, burn_sweeps = pig.LEARN_LAUNCHES, pig.KERNEL_LAUNCHES
    lt = eng.learn_tables()
    tallies = counts.sum(dim=1).cpu().numpy()
    log("  (e) potts%d_card%d: %d variables, kmax %d, %d colors; %d sweep "
        "launches, %d learn launches (+ %d burn-in sweeps); weight %.6f "
        "from %.2f" % (side, k, eng.cg.n_vars, eng.cg.kmax, steps, sweeps,
                       learns, burn_sweeps, float(wl[0]),
                       float(eng.cg.weight_init[0])))
    if sweeps != 12 * steps or burn_sweeps != steps or \
            learns != 5 * learn_launches_per_epoch(lt):
        fail("Potts card %d: launches not as counted" % k)
    if not (np.isin(tallies, (0, 10)).all() and (tallies == 10).any()) or \
            not torch.isfinite(wl).all():
        fail("Potts card %d: tallies or weights out of range" % k)
    err = max(check_equal(torch, "potts%d_card%d" % (side, k), "own", eng,
                          burn=1, epochs=1),
              check_learn_equal(torch, "potts%d_card%d" % (side, k), eng,
                                lp, burn=1, epochs=1))
    rates = {}
    for which in ("kernel", "plain"):
        plain = which == "plain"
        for mode, pts, lpx in (("infer", (1, 3) if plain else (5, 25),
                                None),
                               ("learn", (1, 2) if plain else (2, 10), lp)):
            ups, ms = rate(torch, eng, plain, *pts, lp=lpx)
            rates[(mode, which)] = ms
            log("  potts%d_card%d %s %-6s %.4f ms/epoch (epochs %d..%d); %s"
                % (side, k, mode, which, ms, *pts, card))
    return dict(sweeps=sweeps, learns=learns, err=err, rates=rates,
                sweep_cost=sweep_epoch_cost(torch, eng.tables),
                learn_cost=learn_epoch_cost(torch, lt))


def phase_factors(torch, card):
    """Phase 13; returns what the kernels line reads of (d) and (e)."""
    log("== phase 13: every factor function through the sweep and learn "
        "kernels; %s" % card)
    t0 = time.perf_counter()
    swept, learned = {}, {}
    fixtures = factor_fixtures()
    worst, gworst, t_a, t_l, t_b = _phase13_compare(torch, fixtures, swept,
                                                    learned)
    log("  (a) kernel == plain on %d graphs, max |diff| %g (%.1f s, "
        "learning %.1f s of it); (b) plain potentials vs golden max |diff| "
        "/ max(1, |golden|) %.3g (%.1f s)"
        % (len(fixtures), worst, t_a, t_l, gworst, t_b))
    _phase13_coverage(swept, learned)
    t1 = time.perf_counter()
    _phase13_exact(torch)
    log("  (c) took %.1f s" % (time.perf_counter() - t1))
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        dp = _phase13_dp(torch, work, card)
    log("  (d) took %.1f s" % (time.perf_counter() - t1))
    t1 = time.perf_counter()
    potts = _phase13_potts(torch, card)
    log("  (e) took %.1f s" % (time.perf_counter() - t1))
    t1 = time.perf_counter()
    _phase13_spouse(torch)
    log("  (f) took %.1f s" % (time.perf_counter() - t1))
    log("  phase 13 took %.1f s" % (time.perf_counter() - t0))
    dp["err"] = max(dp["err"], worst)
    return dict(dp=dp, potts=potts)


def _phase13_spouse(torch):
    """Phase 13 (f): the spouse shape (``spouse_shape``, SPOUSE_PAIRS
    pairs), whose runs of 128 rows pass ITEM_TILE items, takes
    learn_item_kernel in every step (its tiles cut at ITEM_CUT items),
    and its learning with featureValues in [0.3, 1.7] (sums that round,
    in the order the tiles fix) equals the plain version bit for bit."""
    from numbskull_tpu_torch import types as T
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.ops import itemgrid as pig
    from numbskull_tpu_torch.ops.gibbs import LearnParams
    eng = pig.ItemGridEngine(compile_graph(*spouse_shape(
        SPOUSE_PAIRS, 11, fv=lambda rng, n: rng.uniform(0.3, 1.7, n))),
        device=DEVICE)
    lt = eng.learn_tables()
    t = lt.sweep
    run = max(int(t.row_item[t.row0[ci] + min(t.n_rows[ci], pig.TILE_ROWS)]
                  - t.row_item[t.row0[ci]]) for ci in range(t.n_steps))
    paths = learn_paths(lt)
    log("  (f) spouse shape: %d rows, %d steps, up to %d items in a step's "
        "first 128 rows, %d tiles, longest piece %d; learn: %s"
        % (t.row0[-1] + t.n_rows[-1], t.n_steps, run, sum(lt.n_tiles),
           max(lt.smem_items), paths))
    if run <= pig.ITEM_TILE or paths != {
            T.FUNC_ISTRUE: {"learn_item"},
            T.FUNC_IMPLY_NATURAL: {"learn_item"}}:
        fail("the spouse shape does not take learn_item_kernel in every "
             "step")
    check_learn_equal(torch, "spouse shape", eng,
                      LearnParams(regularization=2, reg_param=0.01),
                      seed=13, burn=1, epochs=3)


def _cat_entry(r, mode):
    """A kernels-line entry of phase 13's run ``r`` (kernel #1 for
    ``mode`` "infer", #2 for "learn")."""
    launches, cost = ((r["sweeps"], r["sweep_cost"]) if mode == "infer"
                      else (r["learns"], r["learn_cost"]))
    out = dict(launches=launches, max_abs_err=r["err"],
               ms=r["rates"][(mode, "kernel")],
               plain_ms=r["rates"][(mode, "plain")])
    out["bound_ms"], out["bound_by"] = bound(*cost)
    return out


def factors_records(r):
    """The `factors` mode's kernels line: kernels #1 and #2 with phase
    13 (d)'s launches and epoch times on the DP graph, and (e)'s on the
    card-128 Potts grid under ``potts128``."""
    recs = []
    for base, mode in ((SWEEP, "infer"), (LEARN, "learn")):
        rec = dict(base, **_cat_entry(r["dp"], mode), library_ms=None)
        rec["potts128"] = _cat_entry(r["potts"], mode)
        recs.append(rec)
    return recs


def phase_dp_spread(torch, card):
    """The spread of DP_ARGV's results over seeds 0, 1, 2 on the DP
    graph, on both engines: the class mean marginal and each learned
    weight; prints the tolerances (three times the largest spread) that
    DP_TOL_MEAN and DP_TOL_WEIGHT hold."""
    import numpy as np
    log("== DP spread over seeds 0, 1, 2 (%s)" % card)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        gdir = _dp_write(work, DP_CANDIDATES)[0]
        res = {}
        for engine in ("itemgrid", "xla"):
            for seed in (0, 1, 2):
                r = _dp_cli(torch, gdir, work, engine, seed)
                res[(engine, seed)] = (r["mean"], r["weights"])
                log("  %s seed %d: main() %.2f s, class mean %.5f, weights "
                    "%s" % (engine, seed, r["wall"], r["mean"],
                            np.array2string(r["weights"], precision=5)))
    s_mean = max(np.ptp([res[(e, s)][0] for s in range(3)])
                 for e in ("itemgrid", "xla"))
    s_w = max(float(np.ptp(np.stack([res[(e, s)][1] for s in range(3)]),
                           axis=0).max()) for e in ("itemgrid", "xla"))
    d_mean = max(abs(res[("itemgrid", s)][0] - res[("xla", s)][0])
                 for s in range(3))
    d_w = max(float(np.abs(res[("itemgrid", s)][1] -
                           res[("xla", s)][1]).max()) for s in range(3))
    log("  spread: class mean %.6f, weights %.6f; tolerances (3x) %.6f, "
        "%.6f; itemgrid vs xla at one seed: up to %.6f, %.6f"
        % (s_mean, s_w, 3 * s_mean, 3 * s_w, d_mean, d_w))


def finish(torch, card, records):
    log(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def learn_phases(torch, card):
    """The `learn` mode's phases: 2 (learning), 4, 5 (without the Ising
    inference rates) and 7. Returns the arguments of learn_record."""
    worst_l = phase_learn_compare(torch)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        learns, coin_ns, err4 = phase_learn_main_path(torch, work)
        rates, _, err5_l = phase_rates(torch, None, coin_ns, card)
    cost = learn_epoch_cost(
        torch, coin_ns.factorGraphs[0].engine(True).learn_tables())
    del coin_ns
    hbm = phase_hbm(torch, card)
    return (learns, max(worst_l, err4, err5_l),
            rates[("coin400k", "learn")], cost, hbm)


def learn_record(torch, learns, err, learn, cost, hbm):
    """The kernels-line record of the learn kernels (TPU kernel #2, and
    under ``hbm`` #7): launches of phase 4, times of phase 5 on the coin
    graph, the 33.5 M path of phase 7."""
    rec = dict(LEARN, launches=learns, max_abs_err=max(err,
                                                       hbm["err_learn"]),
               ms=learn["kernel"][1], plain_ms=learn["plain"][1],
               library_ms=None)
    rec["bound_ms"], rec["bound_by"] = bound(*cost)
    rec["hbm"] = {"serves": "numbskull_tpu/ops/itemgrid_pallas.py:4027",
                  "launches": hbm["learn_launches"],
                  "ms": hbm["learn_kernel"][1],
                  "plain_ms": hbm["learn_plain"][1],
                  "bound_ms": bound(*hbm["learn_cost"])[0]}
    return rec


def sweep_phases(torch, card):
    """The `sweep` mode's phases: 2 (the sweep), 3 with the sweep's
    epoch-differenced rates on its graph (plain, kernel, kernel, plain),
    and 7. Returns the arguments of sweep_record."""
    worst = phase_compare(torch)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        launches, ising_ns, err3 = phase_main_path(torch, work)
    eng = ising_ns.factorGraphs[0].engine(True)
    meas = {}
    for which in ("plain", "kernel", "kernel", "plain"):
        pts = (2, 12) if which == "plain" else (20, 220)
        ups, ms = rate(torch, eng, which == "plain", *pts)
        meas.setdefault(which, []).append((ups, ms))
        log("  ising1024 infer %-6s %.6g variable updates/s, %.4f ms/epoch "
            "(epochs %d..%d)" % (which, ups, ms, *pts))
    cost = sweep_epoch_cost(torch, eng.tables)
    del ising_ns, eng
    hbm = phase_hbm(torch, card)
    return (launches, max(worst, err3, hbm["err"]),
            {k: max(v) for k, v in meas.items()}, cost, hbm)


def sweep_record(launches, err, sweep, cost, hbm):
    """The kernels-line record of the sweep kernel (TPU kernel #1, and
    under ``hbm`` #6): launches of phase 3, times on the graph of phase
    3, the 33.5 M path of phase 7."""
    rec = dict(SWEEP, launches=launches, max_abs_err=err,
               ms=sweep["kernel"][1], plain_ms=sweep["plain"][1],
               library_ms=None)      # no single PyTorch call does this
    rec["bound_ms"], rec["bound_by"] = bound(*cost)
    rec["hbm"] = {"serves": "numbskull_tpu/ops/itemgrid_pallas.py:3595",
                  "launches": hbm["launches"], "ms": hbm["infer_kernel"][1],
                  "plain_ms": hbm["infer_plain"][1],
                  "bound_ms": bound(*hbm["sweep_cost"])[0],
                  "ms_per_color": hbm["sweep_color_ms"]}
    return rec


def stencil_record(launches, err, lattice):
    """The kernels-line record of the lattice kernel (TPU kernel #8):
    launches of phase 6's main path, ms per sweep at 1024x1024 (and at
    every size under ``sizes``), the bound of a sweep in phase 6's
    250-sweep call."""
    grid = lattice[LATTICES[0]]
    rec = dict(STENCIL, launches=launches, max_abs_err=err,
               ms=grid["kernel"][1], plain_ms=grid["plain"][1],
               library_ms=None)    # no single PyTorch call does this
    rec["bound_ms"], rec["bound_by"], rec["bound_pipe"] = lattice_bound(
        LATTICES[0], 250)
    rec["sizes"] = {str(n): {"ms": r["kernel"][1], "plain_ms": r["plain"][1],
                             "bound_ms": lattice_bound(n, 250)[0]}
                    for n, r in lattice.items()}
    return rec


def main():
    torch = setup()
    card = card_line()
    phase_device(torch)
    if sys.argv[1:] == ["mc"]:        # phases 1 and 8 only
        finish(torch, card, mc_records(phase_mc(torch, card)))
        return
    if sys.argv[1:] == ["bsp"]:       # phases 1 and 9 only
        finish(torch, card, bsp_records(phase_bsp(torch, card)))
        return
    if sys.argv[1:] == ["gather"]:    # phases 1 and 10 only
        finish(torch, card, gather_records(phase_gather(torch, card)))
        return
    if sys.argv[1:] == ["learn"]:     # phases 1, 2 (learning), 4, 5, 7
        finish(torch, card, [learn_record(torch, *learn_phases(torch, card))])
        return
    if sys.argv[1:] == ["sweep"]:     # phases 1, 2 (the sweep), 3, 7
        finish(torch, card, [sweep_record(*sweep_phases(torch, card))])
        return
    if sys.argv[1:] == ["checkpoint"]:    # phases 1 and 11 only
        finish(torch, card, checkpoint_records(
            torch, phase_checkpoint(torch, card)))
        return
    if sys.argv[1:] == ["sharded"]:   # phases 1 and 12 only
        phase_sharded(torch, card)
        finish(torch, card, [])
        return
    if sys.argv[1:] == ["factors"]:   # phases 1 and 13 only
        finish(torch, card, factors_records(phase_factors(torch, card)))
        return
    if sys.argv[1:] == ["kept"]:      # phases 1 and 2 (the two forms)
        phase_kept_form(torch)
        finish(torch, card, [])
        return
    if sys.argv[1:] == ["categorical"]:   # 1, 2 (categorical edges), 13
        err = max(phase_cat_edges(torch), phase_kept_form(torch))
        recs = factors_records(phase_factors(torch, card))
        for rec in recs:
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        finish(torch, card, recs)
        return
    if sys.argv[1:] == ["dpspread"]:  # phase 1, then DP_TOL_*'s spread
        phase_dp_spread(torch, card)
        finish(torch, card, [])
        return
    if sys.argv[1:] == ["lattice"]:   # phases 1, 2 (the lattice), 6
        worst_s = phase_stencil_compare(torch)
        launches, lattice = phase_lattice(torch, card)
        finish(torch, card, [stencil_record(launches, worst_s, lattice)])
        return
    worst = phase_compare(torch)
    worst_l = max(phase_learn_compare(torch), phase_cat_edges(torch),
                  phase_kept_form(torch))
    worst_s = phase_stencil_compare(torch)
    # phase 13 next, while the process holds little: its plain versions
    # run many small tensor ops, which ran a third slower after phase 12
    factors = phase_factors(torch, card)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        launches, ising_ns, err3 = phase_main_path(torch, work)
        learns, coin_ns, err4 = phase_learn_main_path(torch, work)
        rates, err5, err5_l = phase_rates(torch, ising_ns, coin_ns, card)
    sweep_cost = sweep_epoch_cost(
        torch, ising_ns.factorGraphs[0].engine(True).tables)
    learn_cost = learn_epoch_cost(
        torch, coin_ns.factorGraphs[0].engine(True).learn_tables())
    del ising_ns, coin_ns
    stencil_launches, lattice = phase_lattice(torch, card)
    hbm = phase_hbm(torch, card)
    mcr = phase_mc(torch, card)
    bspr = phase_bsp(torch, card)
    gatherr = phase_gather(torch, card)
    phase_checkpoint(torch, card)
    phase_sharded(torch, card)
    records = [
        sweep_record(launches, max(worst, err3, err5, hbm["err"]),
                     rates[("ising1024", "infer")], sweep_cost, hbm),
        learn_record(torch, learns, max(worst_l, err4, err5_l),
                     rates[("coin400k", "learn")], learn_cost, hbm),
        stencil_record(stencil_launches, worst_s, lattice)]
    for rec, mode in zip(records, ("infer", "learn")):
        rec["dp"] = _cat_entry(factors["dp"], mode)
        rec["potts128"] = _cat_entry(factors["potts"], mode)
    records += mc_records(mcr) + bsp_records(bspr) + \
        gather_records(gatherr)
    finish(torch, card, records)


if __name__ == "__main__":
    main()
