"""The comparisons that decide ``correct``: numbers computed from the
program's outputs and the plain reference's, each held to a limit that
the configuration's file states."""

from __future__ import annotations

import numpy as np


def chi2_excess(m, p, n: int) -> float:
    """How far Monte Carlo marginals ``m`` of ``n`` independent draws each
    stray from the exact probabilities ``p``, beyond what ``n`` draws
    spread by: sum((m - p)^2 n / v) / sum(p (1 - p) / v) - 1, with
    v = max(p (1 - p), 1 / n) (the floor keeps a rare draw of a
    near-certain value from dominating). About 0 when every marginal is
    an honest estimate; a marginal that does not move, is left out or is
    altered makes it positive, and one with no spread at all makes it
    -1. Its absolute value is compared."""
    m = np.asarray(m, np.float64)
    p = np.asarray(p, np.float64)
    q = p * (1 - p)
    v = np.maximum(q, 1.0 / n)
    return float(((m - p) ** 2 * n / v).sum() / (q / v).sum() - 1.0)


def weight_gap(w_prog, w_ref, w0) -> float:
    """The worst weight's gap between the program's change from ``w0``
    and the reference's, against the larger of the reference's change
    of that weight and the median weight's change."""
    dp = np.asarray(w_prog, np.float64) - np.asarray(w0, np.float64)
    dr = np.asarray(w_ref, np.float64) - np.asarray(w0, np.float64)
    scale = np.maximum(np.abs(dr), np.median(np.abs(dr)))
    return float((np.abs(dp - dr) / scale).max())


def marginal_readings(p64, plow, n: int, seed: int, x0) -> dict:
    """chi2_excess of marginals drawn, ``n`` draws each, from the exact
    probabilities ``p64`` (a sound run's worth) and from ``plow`` (the
    control), and of the planted faults: every variable left at its
    initial value ``x0`` (unchanged), the upper half left so (half the
    batch), and the sound draws with the variable that leans most moved
    all the way to its other value (an answer altered); each against
    ``p64``."""
    rng = np.random.default_rng(seed)
    sound = rng.binomial(n, p64) / n
    half = sound.copy()
    half[len(half) // 2:] = x0[len(half) // 2:]
    altered = sound.copy()
    v = int(np.abs(sound - 0.5).argmax())
    altered[v] = float(sound[v] < 0.5)
    ms = {"sound": sound, "bf16": rng.binomial(n, plow) / n,
          "unchanged": np.asarray(x0, np.float64), "half_batch": half,
          "altered": altered}
    return {k: {"chi2_excess": abs(chi2_excess(m, p64, n))}
            for k, m in ms.items()}
