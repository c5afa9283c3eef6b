"""A sweep step with no row to update launches nothing.

``build_tables`` records each step's rows with ``ROW_UPDATE``
(``SweepTables.n_update``); ``sweep_color`` returns at once on a step
where that is 0 and no ``send`` asks for its rows' values, on the CPU
and the card alike, and adds 1 to the registry counter
``sweep.skipped_steps``. ``color_step_reference`` still runs every step
and is the semantics the skipping route is held to. The graphs: the
Snorkel EHR graph (``gibbsbench``'s ``snorkel_ehr`` at its tiny size),
whose LF colours are evidence, and the Ising fixture of the
``sample_evidence`` off case (``test_torch_itemgrid``), built here with
the port's own modules. This file imports no JAX: on the card,
``python -m pytest --noconftest tests/test_torch_skipped_steps.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gibbsbench.generators import dp_model
from gibbsbench.tests.helpers import tiny
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import ising_grid
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops import itemgrid as pig

from _torch_threads import cap_threads

cap_threads()

SEED = 2 ** 31 + 12345       # the benchmark's seeds are this large


def _ehr():
    g = dp_model.generate(tiny("ehr.infer")[2]["graph"], 5)
    return compile_graph(g["weight"], g["variable"], g["factor"], g["fmap"],
                         domain_mask=g["domain_mask"])


def _ising_no_sample_evidence():
    w, v, f, fm, dm, _ = ising_grid(5, 5, weight=0.25)
    v["isEvidence"][:5] = 1
    return compile_graph(w, v, f, fm, domain_mask=dm)


GRAPHS = {"ehr_tiny": _ehr,
          "ising_no_sample_evidence": _ising_no_sample_evidence}


def _skipped() -> float:
    return metrics.snapshot()["counters"].get("sweep.skipped_steps", 0)


@pytest.mark.parametrize("se", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_update_count_is_the_rows_with_row_update(name, se):
    """``n_update`` of every step is the count of its rows whose flags
    carry ROW_UPDATE; the EHR LF steps (card 3) read 0 under
    sample_evidence off, and every step is live under on."""
    cg = GRAPHS[name]()
    t = pig.ItemGridEngine(cg, sample_evidence=se, device="cpu").tables
    assert len(t.n_update) == t.n_steps
    for ci in range(t.n_steps):
        lo, n = t.row0[ci], t.n_rows[ci]
        flags = t.row_flags[lo:lo + n]
        assert t.n_update[ci] == int(((flags & pig.ROW_UPDATE) != 0).sum())
        # the tally bit comes only with the update bit
        assert torch.equal((flags & pig.ROW_TALLY) != 0,
                           (flags & pig.ROW_UPDATE) != 0)
    if se:
        assert t.n_update == t.n_rows
    elif name == "ehr_tiny":
        card = np.asarray(cg.var_card)
        lf = [ci for ci in range(t.n_steps)
              if (card[t.row_vid[t.row0[ci]:t.row0[ci] + t.n_rows[ci]]
                       .numpy()] == 3).all()]
        assert len(lf) == 2 and all(t.n_update[ci] == 0 for ci in lf)
        assert sum(1 for n in t.n_update if n) == 1
    else:
        assert 0 < sum(t.n_update) < sum(t.n_rows)


@pytest.mark.parametrize("se", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_skipping_run_equals_plain_run(name, se):
    """``run(plain=False)`` on the CPU (``sweep_color``, which skips)
    equals ``run(plain=True)`` (``color_step_reference`` on every step)
    bit for bit in values and tallies; ``sweep.skipped_steps`` rises by
    the dead steps times the epochs, by 0 with sample_evidence on."""
    eng = pig.ItemGridEngine(GRAPHS[name](), sample_evidence=se,
                             device="cpu")
    burn, epochs = 2, 6
    dead = sum(1 for n in eng.tables.n_update if n == 0)
    s0 = _skipped()
    x, c = eng.run(SEED, burn, epochs)
    assert _skipped() - s0 == dead * (burn + epochs)
    xp, cp = eng.run(SEED, burn, epochs, plain=True)
    assert torch.equal(x, xp) and torch.equal(c, cp)
    if se:
        assert dead == 0
    elif name == "ehr_tiny":
        assert dead == 2
        assert int(c.sum()) == epochs * sum(eng.tables.n_update)


@pytest.mark.parametrize("ci", [0, 1])
def test_dead_step_with_send_still_fills_it(ci):
    """A dead step given ``send`` (the graph-sharded sweep's pack) runs:
    ``send`` receives its rows' values, unchanged, nothing is tallied
    and nothing counts as skipped."""
    eng = pig.ItemGridEngine(_ehr(), sample_evidence=False, device="cpu")
    t, cg = eng.tables, eng.cg
    assert t.n_update[ci] == 0 < t.n_rows[ci]
    x = torch.as_tensor(cg.var_init, dtype=torch.int32).clone()
    x0 = x.clone()
    counts = torch.zeros((cg.n_vars, cg.kmax), dtype=torch.int32)
    w = torch.as_tensor(cg.weight_init, dtype=torch.float32)
    n = t.n_rows[ci]
    send = torch.full((n + 3,), -7, dtype=torch.int32)
    s0 = _skipped()
    pig.sweep_color(t, ci, x, counts, w, pig.seed977_of(SEED), 4, True,
                    send=send)
    assert _skipped() == s0
    vid = t.row_vid[t.row0[ci]:t.row0[ci] + n].to(torch.int64)
    assert torch.equal(send[:n], x0[vid])
    assert (send[n:] == -7).all()
    assert torch.equal(x, x0) and int(counts.sum()) == 0


def test_card_dead_steps_launch_nothing():
    """On the card: the DP graph with sample_evidence off runs its one
    live step a launch an epoch, and equals the plain version bit for
    bit in values and tallies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cg = compile_graph(*chip_smoke.dp_graph(2000, 24, 3))
    eng = pig.ItemGridEngine(cg, sample_evidence=False, device="cuda")
    assert sum(1 for n in eng.tables.n_update if n) == 1 < \
        eng.tables.n_steps
    burn, epochs = 2, 10
    before = pig.KERNEL_LAUNCHES
    x, c = eng.run(SEED, burn, epochs)
    torch.cuda.synchronize()
    assert pig.KERNEL_LAUNCHES - before == burn + epochs
    xp, cp = eng.run(SEED, burn, epochs, plain=True)
    assert torch.equal(x, xp) and torch.equal(c, cp)
