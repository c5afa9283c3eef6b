"""With the timed path broken underneath, a run's ``correct`` comes out
false, by the check that the fault should fail: a step that returns its
state unchanged, half of the batch left out (in learning the mean taken
over the rest), an answer altered where it is produced. The cells run on
one card, so there is no exchange between chips to leave out. The
harness runs as on the card, without its look for one, at a tiny size
on the CPU (the program's plain versions)."""

import contextlib

import pytest
import torch

from gibbsbench.tests.helpers import run_tiny


@contextlib.contextmanager
def patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _engine():
    from numbskull_tpu_torch.ops import itemgrid
    return itemgrid, itemgrid.ItemGridEngine


def unchanged():
    """run and learn hand back the state they were given."""
    _, E = _engine()

    def run(orig):
        def f(self, seed, burn, epochs, weight_value=None, x0=None, **k):
            x = self._tensor(x0, self.cg.var_init, torch.int32)
            return x, torch.zeros((self.cg.n_vars, self.cg.kmax),
                                  dtype=torch.int32, device=self.device)
        return f

    def learn(orig):
        def f(self, seed, burn, epochs, stepsize, decay=1.0, lp=None,
              weight_value=None, x0=None, xe0=None, **k):
            t = self._tensor
            return (t(weight_value, self.cg.weight_init, torch.float32),
                    t(x0, self.cg.var_init, torch.int32),
                    t(xe0, self.cg.var_init, torch.int32))
        return f

    stack = contextlib.ExitStack()
    stack.enter_context(patched(E, "run", run))
    stack.enter_context(patched(E, "learn", learn))
    return stack


def half_batch():
    """Sweeps leave the upper half of each colour's rows unsampled and
    untallied; learning's gradient means leave out the items of that
    half."""
    ig, _ = _engine()

    def sweep(orig):
        def f(t, ci, x, counts, *a, **k):
            lo, n = t.row0[ci], t.n_rows[ci]
            vid = t.row_vid[lo + n // 2:lo + n].long()
            kx, kc = x[vid].clone(), counts[vid].clone()
            orig(t, ci, x, counts, *a, **k)
            x[vid], counts[vid] = kx, kc
        return f

    def sums(orig):
        def f(lt, ci, grad, inc):
            row = lt.sweep.plan_tensors(ci)["it_row"]
            keep = row < lt.sweep.n_rows[ci] // 2
            return orig(lt, ci, torch.where(keep, grad, 0.0),
                        torch.where(keep, inc, 0))
        return f

    stack = contextlib.ExitStack()
    stack.enter_context(patched(ig, "sweep_color", sweep))
    stack.enter_context(patched(ig, "_weight_sums", sums))
    return stack


def altered():
    """One answer altered: the variable whose tallies lean most to one
    value has them all moved to the other; learning's first weight is
    moved by 0.5."""
    _, E = _engine()

    def run(orig):
        def f(self, *a, **k):
            x, c = orig(self, *a, **k)
            v = int((c[:, 1] - c[:, 0]).abs().argmax())
            total = int(c[v].sum())
            lean = int(c[v, 1] > c[v, 0])
            c[v] = 0
            c[v, 1 - lean] = total
            return x, c
        return f

    def learn(orig):
        def f(self, *a, **k):
            w, x, xe = orig(self, *a, **k)
            w[0] += 0.5
            return w, x, xe
        return f

    stack = contextlib.ExitStack()
    stack.enter_context(patched(E, "run", run))
    stack.enter_context(patched(E, "learn", learn))
    return stack


CASES = [
    ("ehr.learn", unchanged, "w_gap"),
    ("ehr.learn", half_batch, "w_gap"),
    ("ehr.learn", altered, "w_gap"),
    ("ehr.infer", unchanged, "chi2_excess"),
    ("ehr.infer", half_batch, "chi2_excess"),
    ("ehr.infer", altered, "chi2_excess"),
]


@pytest.mark.parametrize("cell,fault,check", CASES,
                         ids=["%s-%s" % (c, f.__name__)
                              for c, f, _ in CASES])
def test_fault_fails_its_check(cell, fault, check):
    with fault():
        res = run_tiny(cell)
    assert res["correct"] is False
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]
