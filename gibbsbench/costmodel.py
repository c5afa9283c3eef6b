"""The least time a Gibbs epoch could take on the card, counted from the
factor graph alone: its variables, factors, edges, cardinalities,
weights and evidence (the generator's arrays). Nothing here reads the
program's tables, so a new layout of them cannot move the yardstick.

An epoch resamples every variable it updates once. Per updated variable
v, its potential at each of its ``card_v`` values evaluates each factor
on v: the least work reads each of the factor's arguments, multiplies by
its weight and adds (``arity + 2`` operations a value), and the draw
takes ``card_v`` exponentials, sums and compares (4 a value). Inference
tallies each updated variable's value; learning runs two chains (the
free chain updates every variable, the clamped one the query variables)
and, per factor on an updated variable, the gradient's difference of the
two evaluations (2 operations).

Bytes (each input read once, each output written once): a factor record
8 B (weight id, function code), an edge's variable id 4 B, a variable's
value 1 B and its cardinality 1 B, a weight 4 B, a tally read and
written 4 B each; learning writes each weight once a colour's gradient
is applied, counted once an epoch. The least time is the larger of the
bytes at the card's memory bandwidth and the operations at its float32
rate (``peaks.py``), and :func:`epoch_cost` says which binds.
"""

from __future__ import annotations

import numpy as np

from gibbsbench import peaks

FACTOR_B, EDGE_B, VALUE_B, CARD_B, WEIGHT_B, TALLY_B = 8, 4, 1, 1, 4, 4


def graph_counts(graph: dict) -> dict:
    """The counts :func:`epoch_cost` reads, from a generator's arrays."""
    v, f, fm = graph["variable"], graph["factor"], graph["fmap"]
    arity = f["arity"].astype(np.int64)
    edge_fac = np.repeat(np.arange(len(f)), arity)
    return {"card": v["cardinality"].astype(np.int64),
            "evidence": v["isEvidence"].astype(bool),
            "arity": arity, "edge_var": fm["vid"].astype(np.int64),
            "edge_factor": edge_fac, "n_weights": len(graph["weight"])}


def epoch_cost(counts: dict, phase: str, sample_evidence: bool) -> dict:
    """Bytes, operations and least seconds of one epoch of ``phase``
    ('learning' or 'inference'); ``bound`` names what binds."""
    card, ev = counts["card"], counts["evidence"]
    arity, ev_var, ev_fac = (counts["arity"], counts["edge_var"],
                             counts["edge_factor"])
    learn = phase == "learning"
    upd = np.ones(len(card), bool) if (learn or sample_evidence) else ~ev
    on_upd = upd[ev_var]
    fac_touched = np.zeros(len(arity), bool)
    fac_touched[ev_fac[on_upd]] = True
    n_upd = int(upd.sum())
    per_value = (arity[ev_fac[on_upd]] + 2) * card[ev_var[on_upd]]
    ops = float(per_value.sum() + 4 * card[upd].sum())
    nbytes = float(fac_touched.sum() * FACTOR_B +
                   arity[fac_touched].sum() * EDGE_B +
                   len(card) * (VALUE_B + CARD_B) +
                   n_upd * VALUE_B + counts["n_weights"] * WEIGHT_B)
    if learn:
        q = ~ev
        ops += float(((arity[ev_fac[q[ev_var]]] + 2) *
                      card[ev_var[q[ev_var]]]).sum() + 4 * card[q].sum())
        ops += 2.0 * on_upd.sum()
        nbytes += float(len(card) * VALUE_B + int(q.sum()) * VALUE_B +
                        counts["n_weights"] * WEIGHT_B)
    else:
        nbytes += float(n_upd * 2 * TALLY_B)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = ops / peaks.FP32_FLOPS
    return {"bytes": nbytes, "ops": ops, "seconds": max(t_bytes, t_ops),
            "bound": "bytes" if t_bytes >= t_ops else "operations"}
