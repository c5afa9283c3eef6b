"""The port's mesh engine over real processes, mirroring
tests/test_multihost.py: 4 CPU processes started by
``multihost.spawn`` and joined by a gloo group form a (2, 2)
``global_mesh``; every rank's values, tallies, pooled marginals,
learned weights (L1, so the truncation coin is checked too) and both
chains must equal chain ``r // 2`` of the in-process (2, 2) mesh bit
for bit (dyadic weights: gloo's sum order is then immaterial). Then the
bounds on waiting: a spawn whose peer never reaches a collective raises
at its deadline, and a rendezvous with a missing peer raises after its
timeout."""

import os
import subprocess
import sys
import time

import numpy as np
import torch

from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import ising_color_hint, ising_grid
from numbskull_tpu_torch.ops.gibbs import LearnParams
from numbskull_tpu_torch.parallel import make_mesh, multihost
from numbskull_tpu_torch.parallel.sharded import ShardedGibbsEngine

from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph():
    """A 12x12 Ising, learnable weight 0.25, 30 % evidence."""
    w, v, f, fm, dm, _ = ising_grid(12, 12, weight=0.25, fixed=False)
    rng = np.random.default_rng(8)
    ev = rng.random(len(v)) < 0.3
    v["isEvidence"] = ev.astype(v["isEvidence"].dtype)
    v["initialValue"] = np.where(ev, rng.integers(0, 2, len(v)), 0)
    return compile_graph(w, v, f, fm, domain_mask=dm,
                         color_hint=ising_color_hint(12, 12))


def test_four_processes_equal_in_process(tmp_path):
    from _torch_sharded_worker import run_mesh
    cg = _graph()
    infer_args = (3, 6, 2)                 # seed, epochs, burn
    learn_args = (4, 3, 0.25, 1.0, 1)      # seed, epochs, step, decay, burn
    lp = LearnParams(regularization=1, reg_param=0.25, truncation=2,
                     grad_agg="sum")
    eng = ShardedGibbsEngine(cg, make_mesh(2, 2, device="cpu"))
    st = eng.inference(eng.init_state(), *infer_args)
    marg = eng.marginals(st, infer_args[1])
    ls = eng.learn(eng.init_state(), *learn_args, lp=lp)
    multihost.spawn(run_mesh, 4, (cg, (2,), infer_args, learn_args, lp,
                                  str(tmp_path)), timeout=120)
    for r in range(4):
        got = torch.load(tmp_path / ("rank%d.pt" % r), weights_only=False)
        c = r // 2
        assert (got["chains"], got["shards"]) == ((c,), (r % 2,))
        for name in ("var_value", "count"):
            assert torch.equal(getattr(got["state"], name)[0],
                               getattr(st, name)[c]), (r, name)
        for name in ("var_value", "var_value_evid"):
            assert torch.equal(getattr(got["learned"], name)[0],
                               getattr(ls, name)[c]), (r, name)
        assert torch.equal(got["learned"].weight_value, ls.weight_value)
        assert np.array_equal(got["marg"], marg)
    assert not torch.equal(ls.weight_value, eng.init_state().weight_value)


def test_spawn_deadline_ends_a_stalled_group():
    """Rank 1 never enters the barrier rank 0 waits in: spawn raises
    TimeoutError at its 5 s deadline and leaves no process behind."""
    from _torch_sharded_worker import stall
    import multiprocessing
    t0 = time.monotonic()
    try:
        multihost.spawn(stall, 2, timeout=5)
    except TimeoutError:
        pass
    else:
        raise AssertionError("a stalled spawn returned")
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()


def test_initialize_times_out_without_its_peers(tmp_path):
    """Rank 0 of a world of 2 whose rank 1 never starts: the rendezvous
    raises after the 3 s timeout given to initialize."""
    code = (
        "import datetime, sys\n"
        "from numbskull_tpu_torch.parallel import multihost\n"
        "try:\n"
        "    multihost.initialize('gloo', 'file://' + sys.argv[1], 0, 2,\n"
        "                         datetime.timedelta(seconds=3))\n"
        "except RuntimeError as err:\n"
        "    print('raised', err)\n"
        "else:\n"
        "    sys.exit('joined without its peer')\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "store")], cwd=REPO, check=True,
                         timeout=60, capture_output=True, text=True)
    assert out.stdout.startswith("raised")
    assert time.monotonic() - t0 < 60
