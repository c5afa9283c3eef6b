#!/usr/bin/env python3
"""Smoke test of the PyTorch port (numbskull_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each one that fails exits non-zero; nothing is retried):

1. Device: the card's name and power limit, the torch and CUDA versions,
   and the build (``make -C native``, then nvcc of the sweep, learn,
   exchange, lattice and gather kernels, all five at once).
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
   bit-equal. Then the coin model's marginals on the card against the
   exact joint.
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
   Eight drivers of ``numbskull_tpu_torch/experiments`` (M6's seven
   and ``gather_rates``) at a smoke size, their TSVs checked (columns,
   ``ok``, ``engine``): the main path of both gather kernels.

The line before the last is the kernels' JSON record (per kernel: main
path launches, largest difference from the plain version, ms per epoch
of kernel and plain version (the has_ext forms: per part-epoch on one
part's tables of the 1M Ising; the gathers: per call at shape A and at
the span-8 shape), the bound from this run's shapes at the H100's
3.35 TB/s and 67 TFLOP/s float32 (the lattice's per pipe: int32 at 64
lanes per SM and clock), and under ``hbm`` the 33.5 M path that
kernels #6 and #7 of the TPU package served); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is visible or the port's package is not beside this
script. ``python3 chip_smoke.py mc`` runs phases 1 and 8 only,
``python3 chip_smoke.py bsp`` phases 1 and 9, ``python3 chip_smoke.py
gather`` phases 1 and 10, ``python3 chip_smoke.py learn`` phases 1, 2
(learning), 4, 5 (learning and LF inference) and 7, ``python3
chip_smoke.py sweep`` phases 1, 2 (the sweep), 3 with the sweep's rates
on its graph, and 7, ``python3 chip_smoke.py lattice`` phases 1, 2 (the
lattice) and 6.
"""

from __future__ import annotations

import ctypes
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
LEARN_STEP_KERNELS = ("learn_step_kernel", "learn_item_kernel")
SWEEP_KERNELS = ("sweep_item_kernel", "sweep_color_kernel")
# the sweep kernels as nsx_itemgrid_sweep_attrs numbers them
SWEEP_ATTRS = tuple("sweep_item_kernel<%d, %s>" % (lanes, fast)
                    for fast in ("false", "true")
                    for lanes in (1, 2, 4, 8, 16, 32)) + tuple(
    "sweep_color_kernel<%d>" % k for k in (8, 32, 128))


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
    for n in LATTICES:
        plan = stencil_kernel.lattice_plan(n, n, 250)
        log("  lattice %dx%d plan %s: block %s, %d B dynamic shared memory"
            % (n, n, plan, plan.block, plan.shared_bytes))


def sweep_resources() -> str:
    """The sweep kernels' registers and local memory per thread (spills
    and local arrays) as the loaded module reports them
    (cudaFuncGetAttributes)."""
    from numbskull_tpu_torch.ops import itemgrid
    lib = itemgrid._kernel_lib()
    out = []
    for which, name in enumerate(SWEEP_ATTRS):
        regs, local = ctypes.c_int(), ctypes.c_int()
        rc = lib.nsx_itemgrid_sweep_attrs(which, ctypes.byref(regs),
                                          ctypes.byref(local))
        if rc != 0:
            fail("cudaFuncGetAttributes of %s: CUDA error %d" % (name, rc))
        out.append("%s %d registers, %d B local" % (name, regs.value,
                                                    local.value))
    return "sweep kernels: " + "; ".join(out)


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


def learn_launches_per_epoch(lt) -> int:
    """Learn kernel launches of one epoch on these tables: per color with
    rows, the step kernel, and the sum kernel when it has items."""
    return sum(1 + (lt.n_wt[ci] > 0) for ci in range(lt.sweep.n_steps)
               if lt.sweep.n_rows[ci] > 0)


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
    for i in range(epochs):
        hs = pig.learn_step_of(lp, stepsize, decay, i)
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


def check_learn_equal(torch, name, eng, lp, **kw):
    """compare_learn(), logged; fails on any unequal step or when the
    weights did not move. Returns the max abs difference (0)."""
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
    if moved == 0:
        fail("no weight moved on %s" % name)
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
    n_colors = sum(1 for n in eng.tables.n_rows if n > 0)
    log("  main() took %.2f s (load + compile + %d epochs + dump); "
        "inference %.3f s; %d launches, %d colors"
        % (wall, burn + epochs, fg.inference_total_time, launches,
           n_colors))
    tm = metrics.snapshot()["timings"]
    log("  breakdown (s): " + ", ".join(
        "%s %.3f" % (k, tm[k]["total_s"]) for k in (
            "load.files_s", "load.compile_s", "inference.engine_build_s",
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
    n_colors = sum(1 for n in eng.tables.n_rows if n > 0)
    per_epoch = learn_launches_per_epoch(lt)
    log("  main() took %.2f s; learning %.3f s, inference %.3f s; %d learn "
        "launches (%d per epoch), %d sweep launches, %d colors"
        % (wall, fg.learning_total_time, fg.inference_total_time, learns,
           per_epoch, sweeps, n_colors))
    tm = metrics.snapshot()["timings"]
    log("  breakdown (s): " + ", ".join(
        "%s %.3f" % (k, tm[k]["total_s"]) for k in (
            "load.files_s", "load.compile_s", "learning.engine_build_s",
            "learning.sweep_s", "inference.sweep_s", "dump.marginals_s")))
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
    for i in range(epochs):
        hs = pig.learn_step_of(lp, 0.1, 0.99, i)
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
    for k in ("inference.engine_build_s", "inference.sweep_s",
              "learning.engine_build_s", "learning.sweep_s"):
        out[k] = tm[k]["total_s"]
    log("  FactorGraph(engine='hbm'): inference engine build %.2f s, "
        "%d + %d epochs %.3f s (%d launches); learn tables %.2f s, 1 + %d "
        "epochs %.3f s (%d learn launches)"
        % (out["inference.engine_build_s"], burn, epochs,
           out["inference.sweep_s"], out["launches"],
           out["learning.engine_build_s"], lrn, out["learning.sweep_s"],
           out["learn_launches"]))
    eng = fg.engine(True)
    lt = eng.learn_tables()
    n_colors = sum(1 for r in eng.tables.n_rows if r > 0)
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
    log("  run: %d sweep and %d unpack launches (expected %d, %d); "
        "run_emulated: %d sweep, %d unpack (expected %d, 0)"
        % (n_run[0], n_run[2], sweeps, (burn + epochs) * recv_steps,
           n_emu[0], n_emu[2], sweeps))
    if n_run != (sweeps, 0, (burn + epochs) * recv_steps) or \
            n_emu != (sweeps, 0, 0):
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
    steps = sum(1 for e in eng.engines for n in e.tables.n_rows if n > 0)
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
    if n[0] != burn * steps or n[1] != n[0] or n[3] != epochs * steps or \
            not moved:
        fail("BSP learning on %s: launches %s (expected sweep %d, learn "
             "steps %d, all with ext) or the weights did not move"
             % (name, n, burn * steps, epochs * steps))
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
    """Phase 10 (c): the eight drivers at a smoke size, their TSVs
    checked. The gather kernels' launch counts are set to 0 just before
    and read just after."""
    from numbskull_tpu_torch.experiments import (
        common, degree_sweep, engine_tradeoff, gather_rates, hbm_scale,
        micro_gather, micro_gather2, micro_gather_xla, profile_itemgrid)
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
            timing2=((16, 200, 16),), calls=3)))
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
    if sys.argv[1:] == ["lattice"]:   # phases 1, 2 (the lattice), 6
        worst_s = phase_stencil_compare(torch)
        launches, lattice = phase_lattice(torch, card)
        finish(torch, card, [stencil_record(launches, worst_s, lattice)])
        return
    worst = phase_compare(torch)
    worst_l = phase_learn_compare(torch)
    worst_s = phase_stencil_compare(torch)
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
    records = [
        sweep_record(launches, max(worst, err3, err5, hbm["err"]),
                     rates[("ising1024", "infer")], sweep_cost, hbm),
        learn_record(torch, learns, max(worst_l, err4, err5_l),
                     rates[("coin400k", "learn")], learn_cost, hbm),
        stencil_record(stencil_launches, worst_s, lattice)]
    records += mc_records(mcr) + bsp_records(bspr) + \
        gather_records(gatherr)
    finish(torch, card, records)


if __name__ == "__main__":
    main()
