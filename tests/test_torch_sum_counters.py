"""The weight-sum kernel's counters: at every launch of ``learn_sum_kernel``
the host adds the weights the launch reduces to ``learn.sum_weights`` and
their partial slots to ``learn.sum_partials``, from the learn tables and
with no sync. A fake library stands in for the card's and CPU tensors
for its memory, as in ``test_torch_learn.py``."""

import numpy as np
import pytest
import torch

from numbskull_tpu_torch import types as T
from numbskull_tpu_torch.compile import compile_graph
from numbskull_tpu_torch.models import ising_grid
from numbskull_tpu_torch.observability import metrics
from numbskull_tpu_torch.ops import itemgrid as pig
from numbskull_tpu_torch.ops.gibbs import LearnParams

from _torch_threads import cap_threads

cap_threads()

COUNTERS = ("learn.sum_weights", "learn.sum_partials")


class _FakeLearnLib:
    """Counts the sum launches and records each step launch's form (its
    argument before the stream), and launches nothing."""

    def __init__(self):
        self.sums = 0
        self.forms = []

    def nsx_learn_step(self, *args):
        self.forms.append(args[-2])
        return 0

    def nsx_learn_sum(self, *args):
        self.sums += 1
        return 0


def _zipf_tables(n_vars=1500, n_weights=500, seed=3):
    """A KBC-like graph: boolean candidates, 30 % evidence, 8 to 20
    ISTRUE factors each on feature weights drawn Zipf(1) over
    ``n_weights``, and an IMPLY_NATURAL factor from each even candidate
    to the next on fixed weight 0."""
    rng = np.random.default_rng(seed)
    v = T.new_variables(n_vars)
    v["cardinality"] = 2
    v["isEvidence"] = rng.random(n_vars) < 0.3
    v["initialValue"] = rng.integers(0, 2, n_vars)
    w = T.new_weights(1 + n_weights)
    w["initialValue"] = np.concatenate(([1.0],
                                        rng.normal(0, 0.5, n_weights)))
    w["isFixed"][0] = True
    per = rng.integers(8, 21, n_vars)
    n_feat, n_imp = int(per.sum()), n_vars // 2
    zipf = 1.0 / np.arange(1, n_weights + 1)
    f = T.new_factors(n_feat + n_imp)
    f["factorFunction"] = [T.FACTORS["ISTRUE"]] * n_feat + \
        [T.FACTORS["IMPLY_NATURAL"]] * n_imp
    f["weightId"][:n_feat] = 1 + rng.choice(n_weights, n_feat,
                                            p=zipf / zipf.sum())
    f["featureValue"] = 1.0
    f["arity"] = [1] * n_feat + [2] * n_imp
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(f["arity"])[:-1]))
    fm = T.new_fmap(n_feat + 2 * n_imp)
    fm["vid"][:n_feat] = np.repeat(np.arange(n_vars), per)
    fm["vid"][n_feat:] = np.arange(2 * n_imp)
    return pig.ItemGridEngine(compile_graph(w, v, f, fm),
                              device="cpu").learn_tables()


def _ising_tables():
    w, v, f, fm, _, _ = ising_grid(6, 6, weight=0.2)
    return pig.ItemGridEngine(compile_graph(w, v, f, fm),
                              device="cpu").learn_tables()


@pytest.mark.parametrize("graph", ["zipf", "ising"])
def test_sum_counters_match_the_learn_tables(monkeypatch, graph):
    """Over an epoch's steps each sum launch adds its step's weight
    entries and their partial slots, the sum of the entries' slot runs
    (``wt_np``), and nothing else changes in the registry but the step
    kernel's item counters: one figure a launch. Both graphs' steps are
    one launch each in the `item` form."""
    lt = _zipf_tables() if graph == "zipf" else _ising_tables()
    t = lt.sweep
    fake = _FakeLearnLib()
    monkeypatch.setattr(pig, "LEARN_LAUNCHES", 0)
    monkeypatch.setattr(pig, "_kernel_lib", lambda name="": fake)
    monkeypatch.setattr(pig, "_stream", lambda device: None)
    monkeypatch.setattr(t, "ptrs", (None,) * len(pig._TABLE_FIELDS))
    monkeypatch.setattr(lt, "ptrs", {k: 1 + i for i, k in enumerate((
        "it_fv", "w_fixed", "wt_wid", "wt_p0", "wt_np") + pig._ORDER_FIELDS)})
    x = torch.zeros(t.n_vars, dtype=torch.int32)
    w = torch.zeros(t.n_weights, dtype=torch.float32)
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]
    metrics.reset()
    total = {k: 0 for k in COUNTERS}
    for ci in range(t.n_steps):
        c0 = metrics.snapshot()["counters"]
        sums0 = fake.sums
        pig._launch_learn(lt, ci, x, x.clone(), w, 1, 1 << 16, hs)
        c1 = metrics.snapshot()["counters"]
        changed = {k for k in c1 if c1[k] != c0.get(k, 0.0)}
        assert changed <= set(COUNTERS) | {"learn.items", "learn.kept_items",
                                           "learn.item_form_items"}
        a, m = lt.wt0[ci], lt.n_wt[ci]
        d = {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in COUNTERS}
        want = {"learn.sum_weights": m,
                "learn.sum_partials": int(lt.wt_np[a:a + m].sum())}
        assert fake.sums - sums0 == 1
        assert d == want
        for k in COUNTERS:
            total[k] += d[k]
    assert total["learn.sum_partials"] == len(lt.part_g)
    assert total["learn.sum_weights"] == len(lt.wt_wid)
    if graph == "zipf":
        # Zipf-shared feature weights: many weights, several slots each
        assert total["learn.sum_partials"] > total["learn.sum_weights"] > 100
    assert pig.LEARN_LAUNCHES == 2 * t.n_steps
    assert fake.forms == [pig.LEARN_FORMS.index("item")] * t.n_steps


def test_no_sum_launch_no_count(monkeypatch):
    """A step with no rows launches nothing and counts nothing."""
    lt = _ising_tables()
    t = lt.sweep
    monkeypatch.setattr(t, "n_rows", [0] * t.n_steps)
    monkeypatch.setattr(t, "ptrs", (None,) * len(pig._TABLE_FIELDS))
    monkeypatch.setattr(pig, "_stream", lambda device: None)
    metrics.reset()
    fake = _FakeLearnLib()
    monkeypatch.setattr(pig, "_kernel_lib", lambda name="": fake)
    x = torch.zeros(t.n_vars, dtype=torch.int32)
    hs = pig.learn_steps(LearnParams(), 0.1, 1.0, 1)[0]
    pig._launch_learn(lt, 0, x, x.clone(),
                      torch.zeros(t.n_weights, dtype=torch.float32), 1,
                      1 << 16, hs)
    assert not set(metrics.snapshot()["counters"]) & set(COUNTERS)
    assert fake.forms == [] and fake.sums == 0
