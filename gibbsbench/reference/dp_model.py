"""Plain PyTorch reference of Snorkel's generative model as the
benchmark's DP graph states it (``generators/dp_model.py``).

It works from the generator's data alone (LF outputs, initial classes
and weights, the dependency pairs), in (candidates, LFs) tensors, with
the nine factor functions written out below (upstream
numbskull/inference.py's DP_GEN codes, as the port's ``golden.py``
states them). It imports nothing of the program.

- :func:`posterior` is P(y = 1 | LFs) for every candidate, exactly: the
  class's Markov blanket is all evidence.
- :class:`Learner` is dual-chain Gibbs SGD with the program's stated
  semantics: colours (all LFs but the second of each pair; the second of
  each pair; the classes) visited in that order; per colour both chains
  resample their rows (the clamped chain only the classes), every item
  of the colour's rows gives the gradient f(free) - f(clamped), a
  weight's gradient is the mean over its items in the colour, and the
  weight steps ``w / (1 + reg * step) - step * g`` (L2). Its draws are
  its own (``torch.Generator``), so it agrees with the program in
  distribution, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from gibbsbench.compare import chi2_excess, marginal_readings, weight_gap

ABSTAIN = 2


def _lf_feats(y, l):
    """(accuracy, propensity, class propensity, prior) of LF value ``l``
    with class ``y`` (broadcast)."""
    fired = l != ABSTAIN
    acc = torch.where(fired, torch.where(y == l, 1, -1), 0)
    prop = fired.to(torch.int64)
    cprop = torch.where(fired, torch.where(y == 1, 1, -1), 0)
    prior = torch.where(fired, torch.where(l == 0, 0, 1), -1)
    return acc, prop, cprop, prior


def _fixing(y, l1, l2):
    out = torch.where((l1 == 0) & (l2 == 1) & (y == 1), 1, 0)
    out = torch.where((l1 == 1) & (l2 == 0) & (y == 0), 1, out)
    return torch.where(l1 == ABSTAIN, torch.where(l2 != 1, -1, 0), out)


def _reinforcing(y, l1, l2):
    out = torch.where((l1 == 0) & (l2 == 0) & (y == 0), 1, 0)
    out = torch.where((l1 == 1) & (l2 == 1) & (y == 1), 1, out)
    return torch.where(l1 == ABSTAIN, torch.where(l2 != 1, -1, 0), out)


def _exclusive(l1, l2):
    return torch.where((l1 == ABSTAIN) | (l2 == ABSTAIN), 0, -1)


def _similar(l1, l2):
    return (l1 == l2).to(torch.int64)


DEPS = (_fixing, _reinforcing, _exclusive, _similar)
WITH_Y = (True, True, False, False)


class Model:
    """Weights' layout and potentials of the DP graph with ``L`` LFs:
    w[0] the class prior, w[1 + k*L + j] LF j's k-th kind (accuracy,
    propensity, class propensity, prior), w[1 + 4L + k] dependency k."""

    def __init__(self, data: dict, device, dtype=torch.float64):
        self.dev = torch.device(device)
        self.dtype = dtype
        self.lab = torch.as_tensor(data["lab"], device=self.dev).long()
        self.C, self.L = self.lab.shape
        self.pairs = [tuple(p) for p in data["pairs"]]
        self.y0 = torch.as_tensor(data["y0"], device=self.dev).long()
        self.w0 = torch.as_tensor(data["w0"], dtype=dtype, device=self.dev)

    def kind(self, k: int, w):
        return w[1 + k * self.L:1 + (k + 1) * self.L]

    def dep(self, k: int, w):
        return w[1 + 4 * self.L + k]

    def y_potentials(self, w, lab):
        """(C, 2) potentials of the class at 0 and 1 given LF values
        ``lab`` (C, L)."""
        cols = []
        for v in (0, 1):
            y = torch.full((self.C, 1), v, device=self.dev)
            acc, _, cprop, _ = _lf_feats(y, lab)
            pot = w[0] * (1 if v else -1) + \
                (acc.to(self.dtype) * self.kind(0, w)).sum(1) + \
                (cprop.to(self.dtype) * self.kind(2, w)).sum(1)
            for k in (0, 1):
                a, b = self.pairs[k]
                pot = pot + self.dep(k, w) * DEPS[k](
                    y[:, 0], lab[:, a], lab[:, b]).to(self.dtype)
            cols.append(pot)
        return torch.stack(cols, 1)


def posterior(data: dict, device, dtype=torch.float64) -> torch.Tensor:
    """P(y = 1 | LF outputs) (C,) at the initial weights."""
    m = Model(data, device, dtype)
    pot = m.y_potentials(m.w0, m.lab)
    return torch.sigmoid(pot[:, 1] - pot[:, 0])


class Learner(Model):
    """Dual-chain Gibbs SGD from the generator's initial state; see the
    module docstring. ``half_batch`` plants a fault for the benchmark's
    control readings: the gradient means leave out the upper half of the
    candidates."""

    def __init__(self, data: dict, device, seed: int,
                 dtype=torch.float64, half_batch: bool = False):
        super().__init__(data, device, dtype)
        self.gen = torch.Generator(device=self.dev).manual_seed(
            int(seed) % (2 ** 63))
        self.w = self.w0.clone()
        self.x_l, self.x_y = self.lab.clone(), self.y0.clone()  # free
        self.e_y = self.y0.clone()                        # clamped chain
        second = {b for _, b in self.pairs}
        self.colors = [[j for j in range(self.L) if j not in second],
                       sorted(second)]
        self.keep = torch.ones(self.C, dtype=torch.bool, device=self.dev)
        if half_batch:
            self.keep[self.C // 2:] = False

    def _draw(self, pot):
        p = torch.softmax(pot, dim=-1)
        u = torch.rand(p.shape[:-1] + (1,), generator=self.gen,
                       device=self.dev, dtype=torch.float64).to(p.dtype)
        return (p.cumsum(-1) < u).sum(-1).clamp(max=p.shape[-1] - 1)

    def _mean(self, g):
        """Mean over the kept candidates of (C, ...) item gradients."""
        k = self.keep
        return g[k].to(self.dtype).mean(0)

    def _step(self, idx, g, step):
        """SGD step of weights ``idx`` with gradients ``g``."""
        shrink = 1.0 / (1.0 + self.reg * step)
        w = self.w.clone()
        w[idx] = (self.w[idx] * shrink - step * g).to(self.dtype)
        self.w = w

    def _lf_color(self, js, step):
        L, w = self.L, self.w
        j = torch.as_tensor(js, device=self.dev)
        y_p, y_e = self.x_y[:, None], self.e_y[:, None]
        vals = torch.arange(3, device=self.dev)
        acc, prop, cprop, prior = _lf_feats(y_p[..., None],
                                            vals.view(1, 1, 3))
        pot = sum(f.to(self.dtype) * self.kind(k, w)[j][None, :, None]
                  for k, f in enumerate((acc, prop, cprop, prior)))
        pot = pot.expand(self.C, len(js), 3).clone()
        dep_items = []
        for k, (a, b) in enumerate(self.pairs):
            for pos, me, other in ((1, a, b), (2, b, a)):
                if me not in js:
                    continue
                col = js.index(me)
                lo = self.x_l[:, other][:, None].expand(self.C, 3)
                v3 = vals[None, :].expand(self.C, 3)
                args = (v3, lo) if pos == 1 else (lo, v3)
                f = DEPS[k](self.x_y[:, None], *args) if WITH_Y[k] else \
                    DEPS[k](*args)
                pot[:, col] += self.dep(k, w) * f.to(self.dtype)
                dep_items.append((k, pos, me, other, col))
        new = self._draw(pot)                              # (C, |js|)
        data = self.lab[:, j]
        fp = _lf_feats(y_p, new)
        fe = _lf_feats(y_e, data)
        for k in range(4):
            self._step(1 + k * L + j, self._mean(fp[k] - fe[k]), step)
        for k, pos, me, other, col in dep_items:
            def ev(y, mine, oth):
                args = (mine, oth) if pos == 1 else (oth, mine)
                return DEPS[k](y, *args) if WITH_Y[k] else DEPS[k](*args)
            g = ev(self.x_y, new[:, col], self.x_l[:, other]) - \
                ev(self.e_y, self.lab[:, me], self.lab[:, other])
            self._step(torch.tensor([1 + 4 * L + k], device=self.dev),
                       self._mean(g)[None], step)
        self.x_l[:, j] = new

    def _y_color(self, step):
        L = self.L
        new_p = self._draw(self.y_potentials(self.w, self.x_l))
        new_e = self._draw(self.y_potentials(self.w, self.lab))

        def feats(y, lab):
            acc, _, cprop, _ = _lf_feats(y[:, None], lab)
            deps = [DEPS[k](y, lab[:, a], lab[:, b])
                    for k, (a, b) in enumerate(self.pairs[:2])]
            return torch.where(y == 1, 1, -1), acc, cprop, deps

        pp, pa, pc, pd = feats(new_p, self.x_l)
        ep, ea, ec, ed = feats(new_e, self.lab)
        self._step(torch.tensor([0], device=self.dev),
                   self._mean(pp - ep)[None], step)
        self._step(1 + torch.arange(L, device=self.dev),
                   self._mean(pa - ea), step)
        self._step(1 + 2 * L + torch.arange(L, device=self.dev),
                   self._mean(pc - ec), step)
        for k in (0, 1):
            self._step(torch.tensor([1 + 4 * L + k], device=self.dev),
                       self._mean(pd[k] - ed[k])[None], step)
        self.x_y, self.e_y = new_p, new_e

    def learn(self, epochs: int, stepsize: float, decay: float,
              reg_param: float) -> torch.Tensor:
        """``epochs`` epochs (the step from ``stepsize`` again, as each
        call of the program's learning does); returns the weights."""
        self.reg = float(reg_param)
        for i in range(int(epochs)):
            step = float(stepsize) * float(decay) ** i
            for js in self.colors:
                self._lf_color(js, step)
            self._y_color(step)
        return self.w.clone()


# --- the checks that decide `correct` (see run.py) ---------------------

def _dp_layout(data):
    C, L = data["lab"].shape
    yv = np.arange(C, dtype=np.int64) * (L + 1)
    return yv, yv[:, None] + 1 + np.arange(L)


def _evidence_moved(values, lv, lab) -> int:
    return int((np.asarray(values)[lv] != lab).sum())


def check_learning(cfg, data, out, seed: int, device) -> dict:
    """The weights after each of set-up's learning calls against the
    reference learner's after as many calls (:func:`weight_gap`, the
    first call and the last), and the clamped chain's evidence."""
    lp = cfg["learning"]
    if lp["regularization"] != 2:
        raise ValueError("the reference learner implements L2 only")
    ref = Learner(data, device, seed)
    refw = [ref.learn(lp["n_learning_epoch"], lp["stepsize"], lp["decay"],
                      lp["reg_param"]).cpu().numpy()
            for _ in out["weights"]]
    _, lv = _dp_layout(data)
    return {"w_gap_first": weight_gap(out["weights"][0], refw[0],
                                      data["w0"]),
            "w_gap": weight_gap(out["weights"][-1], refw[-1], data["w0"]),
            "evidence_moved": _evidence_moved(out["values_evid"], lv,
                                              data["lab"])}


def check_inference(cfg, data, out, seed: int, device) -> dict:
    """Every class's tallied marginal against its exact posterior
    (:func:`chi2_excess`), and the free chain's evidence."""
    yv, lv = _dp_layout(data)
    n = int(out["epochs"])
    p = posterior(data, device).cpu().numpy()
    m = out["count"][yv, 1] / n
    return {"chi2_excess": abs(chi2_excess(m, p, n)),
            "evidence_moved": _evidence_moved(out["values"], lv,
                                              data["lab"])}


# --- controls: this reference in the program's place (control.py) -----

def control_learning(cfg, data, seed: int, device, epochs: int = 0) -> dict:
    """The worst weight gaps, against the float64 reference, of a second
    float64 reference (another seed: two sound runs), of the bfloat16
    reference and of the reference with half of the batch left out."""
    lp = cfg["learning"]

    def three(**kw):
        r = Learner(data, device, **kw)
        return [r.learn(lp["n_learning_epoch"], lp["stepsize"],
                        lp["decay"], lp["reg_param"]).double().cpu().numpy()
                for _ in range(3)]

    ref = three(seed=seed)
    out = {}
    for name, kw in (("sound", {"seed": seed + 1}),
                     ("bf16", {"seed": seed + 2, "dtype": torch.bfloat16}),
                     ("half_batch", {"seed": seed + 3, "half_batch": True})):
        w = three(**kw)
        out[name] = {"w_gap_first": weight_gap(w[0], ref[0], data["w0"]),
                     "w_gap": weight_gap(w[2], ref[2], data["w0"])}
    out["unchanged"] = {"w_gap_first": weight_gap(data["w0"], ref[0],
                                                  data["w0"]),
                        "w_gap": weight_gap(data["w0"], ref[2], data["w0"])}
    return out


def control_inference(cfg, data, seed: int, device, epochs: int) -> dict:
    """chi2_excess of marginals drawn from the float64 and the bfloat16
    posteriors, ``epochs`` draws each, and of the planted faults
    (``marginal_readings``)."""
    p64 = posterior(data, device).cpu().numpy()
    plow = posterior(data, device, torch.bfloat16).double().cpu().numpy()
    return marginal_readings(p64, plow, epochs, seed, data["y0"])
