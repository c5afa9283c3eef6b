"""Run one cell of the benchmark of ``numbskull_tpu_torch`` once and print
its result as the last line of standard output.

    python -m gibbsbench.run --workload NAME --seed N --seconds S --trace 0|1

A cell of ``BENCHMARK.json`` names a configuration (its file under
``configs/``: the graph's sizes, the sampler's settings, the generator
and the plain reference, the limits of its checks) and a traffic mix
(``traffic/<name>.json``: repeated library calls of one phase). Set-up generates the graph from ``--seed``
(``generators/``), hands it to the program and warms up the cell's own
phase; the window then repeats the traffic's call for ``--seconds``,
ending at the first call to finish past it. ``--trace 1`` runs the same
and then profiles a short slice of further calls, from which the
per-layer readers (``metrics/<name>.py``) take their numbers. After the
window the program's state is freed and the reference
(``reference/<name>.py``) judges what the timed path produced.

Nothing here imports JAX or the JAX package; a run whose process holds
either once the window has closed fails without a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from gibbsbench import costmodel, trace as tr  # noqa: E402
from gibbsbench.importcheck import loaded_forbidden  # noqa: E402

HERE = os.path.join(ROOT, "gibbsbench")


def load_cell(name: str, root: str = ROOT):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def program_seed(seed: int) -> int:
    """The program's seed: the run's, in 31 bits."""
    return int(seed) % (2 ** 31)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters():
    from numbskull_tpu_torch.ops import itemgrid
    return {k: getattr(itemgrid, k)
            for k in ("KERNEL_LAUNCHES", "LEARN_LAUNCHES")}


def _window(call, seconds: float):
    """Repeat ``call`` until ``seconds`` have passed; (calls, wall s)."""
    n, t0 = 0, time.perf_counter()
    while True:
        call()
        n += 1
        wall = time.perf_counter() - t0
        if wall >= seconds:
            return n, wall


def _traced(run: dict, fn, device):
    import torch
    c0 = _counters()
    with tr.layer_spans():
        _, run["trace"] = tr.traced(fn, torch.device(device).type == "cuda")
    c1 = _counters()
    run["launches"] = {k: c1[k] - c0[k] for k in c0}


def run_calls(cfg, traffic, graph, seed, seconds, trace, device) -> dict:
    """Repeated ``NumbSkull.learning`` or ``.inference`` calls (without
    the dump) on the generated graph."""
    import torch

    from numbskull_tpu_torch.numbskull import NumbSkull
    phase = traffic["phase"]
    ns = NumbSkull(quiet=True, device=device, seed=program_seed(seed),
                   **cfg[phase])
    t0 = time.perf_counter()
    ns.loadFactorGraph(graph["weight"], graph["variable"], graph["factor"],
                       graph["fmap"], graph["domain_mask"], graph["edges"])
    t1 = time.perf_counter()
    fg = ns.factorGraphs[0]
    per_call = cfg[phase]["n_learning_epoch" if phase == "learning"
                          else "n_inference_epoch"]

    def call():
        with torch.profiler.record_function("gibbsbench.%s_call" % phase):
            getattr(ns, phase)(out=False)

    weights = []
    for _ in range(traffic.get("check_calls", 0)):
        call()
        weights.append(fg.getWeights().astype(np.float64))
    for _ in range(traffic.get("warmup_calls", 0)):
        call()
    _sync(device)
    t2 = time.perf_counter()
    res = {"setup_s": t2 - T_START,
           "setup_parts": {"load_graph_s": t1 - t0, "warmup_s": t2 - t1}}
    n, wall = _window(call, seconds)
    res.update(attempted=n, rate=len(graph["variable"]) * n * per_call / wall)
    run = {"phase": phase}
    if trace:
        k = traffic["trace_calls"]
        _traced(run, lambda: [call() for _ in range(k)], device)
        run["trace_epochs"] = k * per_call
        run["cost"] = costmodel.epoch_cost(
            costmodel.graph_counts(graph), phase,
            cfg[phase].get("sample_evidence", True))
    res["run"] = run
    res["peak"] = _peak(device)
    st = fg.state
    res["out"] = {"weights": weights, "values": st.var_value.cpu().numpy(),
                  "values_evid": st.var_value_evid.cpu().numpy(),
                  "count": st.count.cpu().numpy(),
                  "epochs": fg.inference_epochs_done}
    return res


def _peak(device) -> int:
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def _free(device):
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _readers(bench, cell):
    """(name, unit, reader) of the per-layer metrics that list this
    cell under ``workloads``."""
    out = []
    for m in bench["per_layer"]:
        if cell["name"] not in m["workloads"]:
            continue
        path = os.path.join(HERE, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "gibbsbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((m["name"], m["unit"], mod.read))
    return out


def run_cell(bench, cell, cfg, traffic, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result object (without the check
    of ``sys.modules``, which :func:`main` makes)."""
    os.environ.pop("NSX_PLAN_CACHE", None)
    gen = importlib.import_module("gibbsbench.generators." +
                                  cfg["generator"])
    t0 = time.perf_counter()
    graph = gen.generate(cfg["graph"], seed)
    t_gen = time.perf_counter() - t0
    res = run_calls(cfg, traffic, graph, seed, seconds, trace, device)
    data = graph["data"]
    del graph
    _free(device)
    ref = importlib.import_module("gibbsbench.reference." + cfg["reference"])
    check = getattr(ref, "check_" + traffic["phase"])
    values = check(cfg, data, res["out"], seed, device)
    limits = cfg["limits"]
    checks = {k: {"value": float(v), "limit": limits[k]}
              for k, v in values.items()}
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]}
    own = [k for k in e2e if k != "setup_s"]
    if len(own) != 1:
        raise ValueError("%s reports %s besides setup_s; the harness "
                         "measures one" % (cell["name"], own))
    got = {"setup_s": res["setup_s"], own[0]: res["rate"]}
    metrics = {}
    if trace:
        for name, unit, read in _readers(bench, cell):
            v = read(res["run"])
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    else:
        metrics = {k: {"value": float(got[k]), "unit": e2e[k]["unit"]}
                   for k in e2e}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": _device_name(device), "count": cell["chips"],
                   "memory_peak_bytes": res["peak"]}
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in checks.values()),
           "attempted": res["attempted"], "failed": 0,
           "metrics": metrics, "device": device_info,
           "setup_parts": dict(generate_s=t_gen, **res["setup_parts"])}
    t = res["run"].get("trace")
    if trace and t is not None:
        device_info.update(busy_s=t["busy_s"] or 0.0, window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = checks
    return out


def _device_name(device) -> str:
    import torch
    if device != "cuda":
        return device
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("gibbsbench: %s needs %d CUDA device(s), %d visible"
              % (cell["name"], cell["chips"], torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    res = run_cell(bench, cell, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace))
    bad = loaded_forbidden(sys.modules)
    if bad:
        print("gibbsbench: the process holds %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
