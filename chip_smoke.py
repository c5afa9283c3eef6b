#!/usr/bin/env python3
"""Smoke test of the PyTorch port (numbskull_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each one that fails exits non-zero; nothing is retried):

1. Device: the card's name and power limit, the torch and CUDA versions,
   and the build (``make -C native``, then nvcc of the sweep kernel).
2. Kernel against its plain version on the card: for coin, Ising 64x64,
   LF card 3, Potts card 20, 64 and 128, and grouped voting at degree 50
   (arity 51), 5 burn-in plus 20 tallied epochs from the same state
   through the CUDA kernel and through ``color_step_reference``, under
   the port's own schedule and under one that swaps every map and draw
   (so `row`, `tile`, `cdf`, `vec` and `sigmoid2` all run). Dyadic
   weights make potential sums exact in any order, so values and
   counts must be bit-equal. Then the coin model's marginals on the
   card against the exact joint.
3. The main path: a 1024x1024 Ising graph (1,048,576 boolean variables,
   2,095,104 EQUAL factors, weight 0.25) written as DeepDive binary
   files, then ``numbskull_tpu_torch.numbskull.main`` with -i 500 -b 50
   on the GPU. Its outputs are checked, and the kernel's launch count
   must be (500 + 50) x colors. Then the kernel is held bit for bit
   against the plain version on the CLI's own tables (2 burn-in plus 3
   tallied epochs, 524,288 rows per launch).
4. Rates: epoch-differenced variable updates per second (CUDA events),
   kernel and plain version in turns, on the graph of phase 3 and on a
   200,000-copy Snorkel-style LF graph (1.2 M variables), which is first
   held bit for bit against the plain version as in phase 3.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is visible or the port's package is not beside this
script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
GRID = 1024              # phase 3 Ising side
LF_COPIES = 200000       # phase 4 LF graph copies
KERNEL = {"name": "itemgrid_sweep", "route": "cuda",
          "source": "numbskull_tpu_torch/csrc/itemgrid_sweep.cu",
          "replaces": "numbskull_tpu/ops/itemgrid_pallas.py:1597"}


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
    from numbskull_tpu_torch.ops import _build, itemgrid
    t0 = time.perf_counter()
    itemgrid._kernel_lib()
    info = _build.BUILD_INFO.get("itemgrid_sweep")
    log("sweep kernel loaded in %.2f s (nvcc %s)" % (
        time.perf_counter() - t0,
        "%.2f s" % info["seconds"] if info else "cached"))
    if info:
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())


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
    xk = torch.as_tensor(cg.var_init, dtype=torch.int32, device=dev)
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
    log("  %-22s %-8s kmax %3d colors %2d: %d of %d draws equal, "
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


def phase_main_path(torch, workdir):
    """Phase 3; returns (kernel launches, NumbSkull, max kernel-vs-plain
    difference on the main path's own tables)."""
    import numpy as np

    from numbskull_tpu_torch import dataloading
    from numbskull_tpu_torch import numbskull as cli
    from numbskull_tpu_torch.models import ising_grid
    from numbskull_tpu_torch.observability import metrics
    from numbskull_tpu_torch.ops import itemgrid as pig
    log("== phase 3: CLI main path, %dx%d Ising on the card" % (GRID, GRID))
    t0 = time.perf_counter()
    w, v, f, fm, _, _ = ising_grid(GRID, GRID, weight=0.25)
    gdir = os.path.join(workdir, "ising1024")
    dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    log("  wrote %d variables, %d factors in %.2f s"
        % (len(v), len(f), time.perf_counter() - t0))
    out = os.path.join(workdir, "out")
    burn, epochs = 50, 500
    metrics.reset()
    pig.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    ns = cli.main([gdir, "-i", str(epochs), "-b", str(burn), "-o", out,
                   "-q", "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = pig.KERNEL_LAUNCHES
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
    return launches, ns, err


def _time_epochs(torch, fn, epochs):
    """CUDA-event time (ms) of fn(epochs)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(epochs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _plain_run(torch, eng, seed, epochs):
    """ItemGridEngine.run through color_step_reference (the plain
    version) on the card."""
    from numbskull_tpu_torch.ops import itemgrid as pig
    cg, dev = eng.cg, eng.device
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32, device=dev)
    x = torch.as_tensor(cg.var_init, dtype=torch.int32, device=dev)
    counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32,
                         device=dev)
    s977 = pig.seed977_of(seed)
    for epoch in range(epochs):
        for ci in range(eng.tables.n_steps):
            pig.color_step_reference(eng.tables, ci, x, counts, w, s977,
                                     epoch, True)
    return x, counts


def rate(torch, eng, plain, lo, hi):
    """Epoch-differenced variable updates per second and ms per epoch."""
    if plain:
        def fn(e):
            _plain_run(torch, eng, 1, e)
    else:
        def fn(e):
            eng.run(1, 0, e)
    fn(1)                                           # warm up
    t_lo = min(_time_epochs(torch, fn, lo) for _ in range(2))
    t_hi = min(_time_epochs(torch, fn, hi) for _ in range(2))
    per_ms = (t_hi - t_lo) / (hi - lo)
    return eng.cg.n_vars / (per_ms / 1e3), per_ms


def device_busy(torch, fn):
    """Share of a window's wall time that the device spent in kernels
    (torch.profiler), or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages())
    return dev_us / wall_us if dev_us > 0 else None


def phase_rates(torch, ns, card):
    """Phase 4; returns (kernel ms, plain ms) per epoch on the Ising and
    the max kernel-vs-plain difference on the LF graph."""
    from numbskull_tpu_torch.compile import compile_graph
    from numbskull_tpu_torch.models import lf_model
    from numbskull_tpu_torch.ops import itemgrid as pig
    log("== phase 4: epoch-differenced rates (CUDA events), " + card)
    t0 = time.perf_counter()
    w, v, f, fm, dm, _ = lf_model(0.7, [0.5, 0.25, 0.75, 0.5, 1.0],
                                  copies=LF_COPIES, seed=3)
    lf_eng = pig.ItemGridEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                                device=DEVICE)
    log("  lf graph: %d variables, %d factors, %d colors, kmax %d "
        "(built in %.1f s)" % (len(v), len(f), lf_eng.cg.n_colors,
                               lf_eng.cg.kmax, time.perf_counter() - t0))
    err = check_equal(torch, "lf200k", "own", lf_eng, burn=2, epochs=3)
    graphs = (("ising1024", ns.factorGraphs[0].engine(True), (20, 220),
               (2, 12)),
              ("lf200k", lf_eng, (20, 220), (2, 12)))
    result = {}
    for gname, eng, kern_pts, plain_pts in graphs:
        meas = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            pts = plain_pts if which == "plain" else kern_pts
            ups, ms = rate(torch, eng, which == "plain", *pts)
            meas.setdefault(which, []).append((ups, ms))
            log("  %-9s %-6s %.6g variable updates/s, %.4f ms/epoch "
                "(epochs %d..%d)" % (gname, which, ups, ms, *pts))
        result[gname] = {k: max(vs) for k, vs in meas.items()}
        busy = device_busy(torch, lambda: eng.run(1, 0, 50))
        log("  %-9s kernel device busy share over 50 epochs: %s"
            % (gname, "not measured (no device time in the trace)"
               if busy is None else "%.3f" % busy))
    ising = result["ising1024"]
    return ising["kernel"][1], ising["plain"][1], err


def main():
    torch = setup()
    card = card_line()
    phase_device(torch)
    worst = phase_compare(torch)
    with tempfile.TemporaryDirectory(prefix="nsx_chip_smoke_") as work:
        launches, ns, err3 = phase_main_path(torch, work)
        k_ms, p_ms, err4 = phase_rates(torch, ns, card)
    worst = max(worst, err3, err4)
    record = dict(KERNEL, launches=launches, max_abs_err=worst, ms=k_ms,
                  plain_ms=p_ms)
    log(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
