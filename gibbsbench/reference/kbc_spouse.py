"""Plain PyTorch reference of DeepDive's spouse graph as the benchmark's
KBC generator states it (``generators/kbc_spouse.py``).

It works from the generator's data alone (sentences, feature lists,
labels, initial weights and values), with the two factor functions the
graph uses written out from upstream numbskull's definitions
(numbskull/inference.py ``eval_factor``: ISTRUE is 1 when its variable
is true and -1 when false; IMPLY_NATURAL returns 0 at the first false
argument and else 1 or -1 as the head is true or false, and since its
search for a false argument runs over the head too, a false head gives
0: an IMPLY_NATURAL factor of (body, head) is 1 when both are true and
0 otherwise). It imports nothing of the program.

- :func:`exact` gives every candidate's marginal exactly: each sentence
  is a connected component of at most 12 boolean variables, so its
  2^(k(k-1)) states are enumerated (float64, in blocks of sentences),
  and with it each candidate's integrated autocorrelation time under
  the sweep's colour order (:func:`_two_block_tau`), from which its
  effective number of draws follows (:func:`infer_number`).
- :class:`Chains` is chromatic Gibbs sampling with the program's stated
  semantics: every sentence of k mentions has its candidates in the
  colours :data:`COLORS` gives (the program's greedy colouring of the
  conflict graph gives every such sentence the same ones), the colours
  visited in order 0, 1, 2, 3, each colour's variables drawn together
  from values before the step. Learning (``learn``) is dual-chain SGD:
  the free chain resamples every variable, the clamped chain the query
  variables; each colour's evidence rows give the gradient
  ISTRUE(free) - ISTRUE(label) per feature item, a weight's gradient is
  the mean over its items in the colour, and every weight with items
  steps ``w / (1 + reg * step) - step * g`` (L2), the step
  ``stepsize * decay^i`` in epoch i of a call. Fixed weights never move.
  Its draws are its own (``torch.Generator``), so it agrees with the
  program in distribution, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from gibbsbench.compare import chi2_excess, weight_gap
from gibbsbench.generators.kbc_spouse import layout

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: each candidate's colour in a sentence of k mentions, candidates in
#: (i, j) order
COLORS = {2: (1, 0), 3: (1, 0, 0, 1, 1, 0),
          4: (3, 1, 0, 2, 1, 0, 2, 0, 1, 2, 1, 0)}
N_COLORS = 4
#: sentences a block of the enumeration holds, by k
BLOCK = {2: 1 << 16, 3: 1 << 14, 4: 1 << 10}


def _dev(device):
    return torch.device(device)


def sentence_fields(data: dict, w, device, dtype=torch.float64):
    """Each candidate's ISTRUE field, the sum of its features' weights
    (V,), added in ``dtype``."""
    dev = _dev(device)
    ptr = np.asarray(data["feat_ptr"])
    V = len(ptr) - 1
    var = torch.as_tensor(np.repeat(np.arange(V), np.diff(ptr)), device=dev)
    wid = torch.as_tensor(np.asarray(data["feat_wid"], np.int64), device=dev)
    w = torch.as_tensor(np.asarray(w), device=dev).to(dtype)
    return torch.zeros(V, dtype=dtype, device=dev).index_add_(0, var, w[wid])


def _states(n: int, dev, dtype):
    s = torch.arange(1 << n, device=dev)
    return ((s[:, None] >> torch.arange(n, device=dev)) & 1).to(dtype)


def _imply_energy(k: int, X, rule_w):
    """Energy of the IMPLY factors of a k-mention sentence at every state
    ``X`` (states, k(k-1)): symmetry and one marriage."""
    _, rev, mar = layout(k)
    n = k * (k - 1)
    body = np.concatenate((np.arange(n), mar[:, 0]))
    head = np.concatenate((rev, mar[:, 1]))
    wf = torch.as_tensor(np.concatenate((np.full(n, rule_w[0]),
                                         np.full(len(mar), rule_w[1]))),
                         dtype=X.dtype, device=X.device)
    return ((X[:, body] * X[:, head]) * wf).sum(1)


def _two_block_tau(P, in_a, dev):
    """Integrated autocorrelation times (B, n) of each variable of a
    sentence whose joint is ``P`` (B, 2^n) under a sweep that draws the
    variables of mask ``in_a`` together, then the rest: a variable of
    block A is observed through the chain K_A(a, a') = sum_b P(b | a)
    P(a' | b) on A's states, one of B through its counterpart; the time
    is the asymptotic variance of its mean over its variance."""
    B, S = P.shape
    n = S.bit_length() - 1
    idx = np.arange(n)
    a_bits, b_bits = idx[in_a], idx[~in_a]
    s = np.arange(S)
    a_of = sum(((s >> i) & 1) << r for r, i in enumerate(a_bits))
    b_of = sum(((s >> i) & 1) << r for r, i in enumerate(b_bits))
    J = torch.zeros((B, 1 << len(a_bits), 1 << len(b_bits)),
                    dtype=P.dtype, device=dev)
    J[:, torch.as_tensor(a_of, device=dev),
      torch.as_tensor(b_of, device=dev)] = P
    tau = torch.ones((B, n), dtype=P.dtype, device=dev)
    for bits, joint in ((a_bits, J), (b_bits, J.transpose(1, 2))):
        mu = joint.sum(2)                          # (B, A)
        nu = joint.sum(1)                          # (B, Bk)
        fwd = joint / mu.clamp_min(1e-300)[:, :, None]
        back = joint / nu.clamp_min(1e-300)[:, None, :]
        K = fwd @ back.transpose(1, 2)             # (B, A, A)
        m = K.shape[1]
        I = torch.eye(m, dtype=P.dtype, device=dev)
        Z = torch.linalg.inv(I - K + mu[:, None, :])
        st = torch.arange(m, device=dev)
        for r, i in enumerate(bits):
            f = ((st >> r) & 1).to(P.dtype)
            mean = (mu * f).sum(1, keepdim=True)
            g = f[None] - mean
            h = (Z @ g[:, :, None])[:, :, 0]
            var = (mu * g * g).sum(1)
            sig = 2 * (mu * g * h).sum(1) - var
            tau[:, i] = torch.where(var > 1e-12, sig / var.clamp_min(1e-300),
                                    torch.ones_like(var))
    return tau.clamp_min(1.0)


def exact(data: dict, w, device, dtype=torch.float64, with_tau=True):
    """(P(candidate true) (V,), its integrated autocorrelation time (V,)
    or None) at weights ``w``, from each sentence's states enumerated in
    ``dtype``. The times are exact for k = 2 and 3 (two colours); a
    4-mention sentence's four colours make 4096 states too many for the
    chain, so each candidate takes the time of the two-colour chain of
    it and its reverse with their exact joint."""
    dev = _dev(device)
    k_of = np.asarray(data["k"], np.int64)
    cand0 = np.asarray(data["cand0"], np.int64)
    F = sentence_fields(data, w, dev, dtype)
    rule_w = np.asarray(w, np.float64)[:2]
    V = len(F)
    p = torch.zeros(V, dtype=torch.float64, device=dev)
    tau = torch.ones(V, dtype=torch.float64, device=dev) if with_tau \
        else None
    for k in (2, 3, 4):
        sel = np.flatnonzero(k_of == k)
        if not len(sel):
            continue
        n = k * (k - 1)
        X = _states(n, dev, dtype)
        e_imp = _imply_energy(k, X, rule_w)
        Xs = 2 * X - 1
        col = np.asarray(COLORS[k])
        _, rev, _ = layout(k)
        for a in range(0, len(sel), BLOCK[k]):
            s = sel[a:a + BLOCK[k]]
            vid = torch.as_tensor(cand0[s][:, None] + np.arange(n),
                                  device=dev)
            E = F[vid] @ Xs.T + e_imp
            P = torch.softmax(E, dim=1)
            p[vid] = (P @ X).double()
            if not with_tau:
                continue
            P = P.double()
            if k < 4:
                tau[vid] = _two_block_tau(P, col == col[0], dev)
                continue
            Xd = X.double()
            one = np.arange(n) < rev
            pr = torch.as_tensor(np.flatnonzero(one), device=dev)
            rv = torch.as_tensor(rev[one], device=dev)
            # the pair's joint over (x_i, x_rev) as four states 0..3
            pi = torch.stack([(P @ ((Xd[:, pr] == a) & (Xd[:, rv] == b))
                               .double()) for b in (0, 1) for a in (0, 1)],
                             2)                      # (B, pairs, 4)
            t = _two_block_tau(pi.reshape(-1, 4), np.array([True, False]),
                               dev).reshape(len(s), len(pr), 2)
            tau[vid[:, pr]] = t[:, :, 0]
            tau[vid[:, rv]] = t[:, :, 1]
    return p, tau


def colors_of(data: dict) -> np.ndarray:
    """Every candidate's colour (V,)."""
    k = np.asarray(data["k"], np.int64)
    out = np.zeros(int(np.asarray(data["cand0"])[-1]), np.int64)
    cand0 = np.asarray(data["cand0"], np.int64)
    for kk, col in COLORS.items():
        sel = np.flatnonzero(k == kk)
        n = kk * (kk - 1)
        out[(cand0[sel][:, None] + np.arange(n)).ravel()] = np.tile(
            col, len(sel))
    return out


def imply_factors(data: dict) -> np.ndarray:
    """Every IMPLY factor as (body, head, weight id) rows."""
    k = np.asarray(data["k"], np.int64)
    cand0 = np.asarray(data["cand0"], np.int64)
    rows = []
    for kk in COLORS:
        sel = np.flatnonzero(k == kk)
        if not len(sel):
            continue
        n = kk * (kk - 1)
        _, rev, mar = layout(kk)
        base = cand0[sel][:, None]
        for body, head, wid in ((np.arange(n), rev, 0),
                                (mar[:, 0], mar[:, 1], 1)):
            b = (base + body).ravel()
            rows.append(np.stack([b, (base + head).ravel(),
                                  np.full(len(b), wid)], 1))
    return np.concatenate(rows) if rows else np.zeros((0, 3), np.int64)


class Chains:
    """Chromatic Gibbs sampling of the spouse graph in ``dtype``; see the
    module docstring. ``half_batch`` plants a fault for the control
    readings: the gradient means leave out the upper half of each
    colour's rows (in variable order)."""

    def __init__(self, data: dict, device, seed: int,
                 dtype=torch.float64, half_batch: bool = False):
        dev = self.dev = _dev(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=dev).manual_seed(
            int(seed) % (2 ** 63))
        self.w0 = np.asarray(data["w0"], np.float64)
        self.w = torch.tensor(self.w0, device=dev).to(dtype)
        fixed = np.asarray(data["fixed"], bool)
        evid = np.asarray(data["evidence"], bool)
        label = np.asarray(data["label"], np.int64)
        x0 = torch.as_tensor(np.asarray(data["x0"], np.int64), device=dev)
        self.x, self.xe = x0.clone(), x0.clone()
        ptr = np.asarray(data["feat_ptr"], np.int64)
        fwid = np.asarray(data["feat_wid"], np.int64)
        V = len(ptr) - 1
        color = colors_of(data)
        imp = imply_factors(data)
        # an IMPLY factor adds w * x_other to the log-odds of its body
        # and of its head
        e_var = np.concatenate((imp[:, 0], imp[:, 1]))
        e_oth = np.concatenate((imp[:, 1], imp[:, 0]))
        e_wid = np.concatenate((imp[:, 2], imp[:, 2]))
        f_var = np.repeat(np.arange(V), np.diff(ptr))

        def t(a, dtype=None):
            return torch.as_tensor(a, device=dev) if dtype is None else \
                torch.as_tensor(a, device=dev).to(dtype)

        self.steps = []
        for c in range(N_COLORS):
            vids = np.flatnonzero(color == c)
            local = np.full(V, -1, np.int64)
            local[vids] = np.arange(len(vids))
            fs = np.flatnonzero(color[f_var] == c)
            es = np.flatnonzero(color[e_var] == c)
            # gradient items: features of the colour's evidence rows
            keep = evid[vids]
            if half_batch:
                keep = keep & (np.arange(len(vids)) < len(vids) // 2)
            gi = fs[keep[local[f_var[fs]]]]
            gw, inv = np.unique(fwid[gi], return_inverse=True)
            learn = ~fixed[gw]
            self.steps.append(dict(
                vid=t(vids), n=len(vids),
                f_loc=t(local[f_var[fs]]), f_wid=t(fwid[fs]),
                e_loc=t(local[e_var[es]]), e_oth=t(e_oth[es]),
                e_wid=t(e_wid[es]),
                query=t(~evid[vids]),
                g_loc=t(local[f_var[gi]]),
                g_lab=t(2 * label[f_var[gi]] - 1, dtype),
                g_inv=t(inv), g_wid=t(gw[learn]), g_sel=t(learn),
                g_cnt=t(np.bincount(inv, minlength=len(gw))[learn],
                        dtype)))

    def _field(self, s: dict):
        """What the colour's variables' features add to their log-odds
        of true: twice the sum of their weights."""
        f = torch.zeros(s["n"], dtype=self.dtype, device=self.dev)
        return f.index_add_(0, s["f_loc"], 2 * self.w[s["f_wid"]])

    def _logodds(self, s: dict, field, x):
        """The colour's variables' log-odds of true given ``x``."""
        xo = x[s["e_oth"]].to(self.dtype)
        return field.clone().index_add_(0, s["e_loc"],
                                         self.w[s["e_wid"]] * xo)

    def _draw(self, lo):
        u = torch.rand(lo.shape, generator=self.gen, device=self.dev,
                       dtype=torch.float64).to(lo.dtype)
        return (u < torch.sigmoid(lo)).to(torch.int64)

    def sweep(self, epochs: int, counts=None):
        """``epochs`` epochs of the free chain; tallies the trues into
        ``counts`` (V,) after each when given."""
        fields = [self._field(s) for s in self.steps]
        for _ in range(int(epochs)):
            for s, f in zip(self.steps, fields):
                if s["n"]:
                    self.x[s["vid"]] = self._draw(self._logodds(s, f,
                                                                self.x))
            if counts is not None:
                counts += self.x

    def learn(self, epochs: int, stepsize: float, decay: float,
              reg_param: float) -> np.ndarray:
        """One learning call of ``epochs`` epochs; returns the weights."""
        for i in range(int(epochs)):
            step = float(stepsize) * float(decay) ** i
            shrink = 1.0 / (1.0 + float(reg_param) * step)
            for s in self.steps:
                if not s["n"]:
                    continue
                f = self._field(s)
                new_p = self._draw(self._logodds(s, f, self.x))
                new_e = self._draw(self._logodds(s, f, self.xe))
                self.x[s["vid"]] = new_p
                self.xe[s["vid"]] = torch.where(s["query"], new_e,
                                                self.xe[s["vid"]])
                if not len(s["g_wid"]):
                    continue
                g = (2 * new_p[s["g_loc"]] - 1).to(self.dtype) - s["g_lab"]
                gs = torch.zeros(len(s["g_sel"]), dtype=self.dtype,
                                 device=self.dev).index_add_(0, s["g_inv"],
                                                             g)
                gm = gs[s["g_sel"]] / s["g_cnt"]
                wv = self.w[s["g_wid"]]
                self.w[s["g_wid"]] = (wv * shrink - step * gm).to(self.dtype)
        return self.w.double().cpu().numpy().copy()


# --- the checks that decide `correct` (see run.py) ---------------------

def _ref_calls(cfg, data, seed, device, n_calls, **kw):
    lp = cfg["learning"]
    if lp["regularization"] != 2 or lp["learn_non_evidence"]:
        raise ValueError("the reference learner implements L2 on "
                         "evidence rows only")
    ch = Chains(data, device, seed, **kw)
    return [ch.learn(lp["n_learning_epoch"], lp["stepsize"], lp["decay"],
                     lp["reg_param"]) for _ in range(n_calls)]


def _factors_of(data) -> np.ndarray:
    return np.bincount(np.asarray(data["feat_wid"], np.int64),
                       minlength=len(data["w0"]))


def learn_numbers(cfg, data, w_first, w_last, ref_first, ref_last,
                  min_factors: int | None = None) -> dict:
    """``w_gap_first``, ``w_gap``: :func:`weight_gap` over the learnable
    weights that at least ``min_factors`` factors share (by default the
    share ``check["min_factor_share"]`` of the feature factors), after
    the first and the last call; ``w_l2``: |change(program) -
    change(reference)| / |change(reference)| over every learnable
    weight, each weighted by its factors; ``unmoved``: the share of the
    learnable weights that have evidence items (and |w0| >= 1e-3, so
    that each step's shrink moves them in float32) at exactly their
    initial float32 value after both the first and the last call (a
    sound run's weight can come back to it by chance at one call: one
    in 544,826 did, on one seed of the full graph); ``fixed_moved``: the
    fixed weights that moved."""
    w0 = np.asarray(data["w0"], np.float64)
    fixed = np.asarray(data["fixed"], bool)
    nf = _factors_of(data)
    learn = ~fixed
    if min_factors is None:
        min_factors = cfg["check"]["min_factor_share"] * nf.sum()
    many = learn & (nf >= min_factors)
    if not many.any():
        raise ValueError("no learnable weight has %g factors" % min_factors)
    ev_var = np.repeat(np.asarray(data["evidence"], bool),
                       np.diff(np.asarray(data["feat_ptr"])))
    has_ev = np.zeros(len(w0), bool)
    has_ev[np.asarray(data["feat_wid"])[ev_var]] = True
    w32 = w0.astype(np.float32)
    live = learn & has_ev & (np.abs(w0) >= 1e-3)
    wl = np.asarray(w_last, np.float64)
    dp, dr = wl - w0, np.asarray(ref_last, np.float64) - w0
    return {
        "w_gap_first": weight_gap(np.asarray(w_first)[many],
                                  np.asarray(ref_first)[many], w0[many]),
        "w_gap": weight_gap(wl[many], np.asarray(ref_last)[many], w0[many]),
        "w_l2": float(np.sqrt((nf * (dp - dr) ** 2)[learn].sum() /
                              max((nf * dr ** 2)[learn].sum(), 1e-300))),
        "unmoved": float(((np.asarray(w_first, np.float32)[live] ==
                           w32[live]) &
                          (np.asarray(w_last, np.float32)[live] ==
                           w32[live])).mean()) if live.any() else 0.0,
        "fixed_moved": int((np.asarray(w_last, np.float32)[fixed] !=
                            w32[fixed]).sum())}


def check_learning(cfg, data, out, seed: int, device) -> dict:
    """The weights after set-up's first and last learning calls against
    the reference learner's after as many calls (:func:`learn_numbers`),
    and the clamped chain's evidence (``evidence_moved``)."""
    ref = _ref_calls(cfg, data, seed, device, len(out["weights"]))
    r = learn_numbers(cfg, data, out["weights"][0], out["weights"][-1],
                      ref[0], ref[-1])
    ev = np.asarray(data["evidence"], bool)
    r["evidence_moved"] = int((np.asarray(out["values_evid"])[ev] !=
                               np.asarray(data["label"])[ev]).sum())
    return r


def infer_number(m, p, tau, n: int) -> float:
    """``chi2_excess`` (compare.py) of marginals ``m`` after ``n`` epochs
    against the exact ``p``, each variable's draws counted as n / tau,
    its effective number."""
    n_eff = n / np.asarray(tau, np.float64)
    return abs(chi2_excess(m, p, n_eff))


def check_inference(cfg, data, out, seed: int, device) -> dict:
    """Every candidate's tallied marginal against its exact marginal at
    the initial weights, its draws counted by its autocorrelation time
    (:func:`infer_number`)."""
    n = int(out["epochs"])
    p, tau = exact(data, data["w0"], device)
    m = np.asarray(out["count"])[:, 1] / n
    return {"chi2_excess": infer_number(m, p.cpu().numpy(),
                                        tau.cpu().numpy(), n)}


# --- controls: this reference in the program's place (control.py) -----

def control_learning(cfg, data, seed: int, device, epochs: int = 0) -> dict:
    """The learning numbers, against the float64 reference, of a second
    float64 reference (another seed: two sound runs), of the bfloat16
    reference, of the reference with half of the batch left out, and of
    weights left unchanged."""
    ref = _ref_calls(cfg, data, seed, device, 3)
    out = {}
    for name, kw in (("sound", {}), ("bf16", {"dtype": torch.bfloat16}),
                     ("half_batch", {"half_batch": True})):
        w = _ref_calls(cfg, data, seed + 1 + len(out), device, 3, **kw)
        out[name] = learn_numbers(cfg, data, w[0], w[2], ref[0], ref[2])
    w0 = data["w0"]
    out["unchanged"] = learn_numbers(cfg, data, w0, w0, ref[0], ref[2])
    return out


def control_inference(cfg, data, seed: int, device, epochs: int) -> dict:
    """``chi2_excess`` of the reference's own chains run ``epochs``
    epochs in float64 (a sound run) and in bfloat16 (potentials and
    draws), and of the planted faults on the sound tallies: every
    variable left at its initial value (unchanged), the upper half of
    each colour's rows never drawn nor tallied (half the batch), and the
    variable whose tallies lean most moved to its other value."""
    p, tau = exact(data, data["w0"], device)
    p, tau = p.cpu().numpy(), tau.cpu().numpy()
    n = int(epochs)
    ms = {}
    for name, dtype in (("sound", torch.float64), ("bf16", torch.bfloat16)):
        ch = Chains(data, device, seed + len(ms), dtype)
        c = torch.zeros(len(p), dtype=torch.int64, device=ch.dev)
        ch.sweep(n, c)
        ms[name] = c.cpu().numpy() / n
    sound = ms["sound"]
    ms["unchanged"] = np.asarray(data["x0"], np.float64)
    half = sound.copy()
    color = colors_of(data)
    for c in range(N_COLORS):
        vids = np.flatnonzero(color == c)
        half[vids[len(vids) // 2:]] = 0.0
    ms["half_batch"] = half
    alt = sound.copy()
    v = int(np.abs(sound - 0.5).argmax())
    alt[v] = float(sound[v] < 0.5)
    ms["altered"] = alt
    return {k: {"chi2_excess": infer_number(m, p, tau, n)}
            for k, m in ms.items()}
