"""spouse.partials_per_weight: the partial slots the weight-sum kernel
reduces per weight, the program's counter ``learn.sum_partials`` over
``learn.sum_weights`` (both added by the host at every sum launch, from
the learn tables), over the run's process. A program without the
counters gives None, as does a run off the card (a traced slice with no
device intervals), as the span readers do."""

from gibbsbench import spans


def read(run: dict):
    if run.get("phase") != "learning" or not spans._on_card(run):
        return None
    counters = spans._snapshot()["counters"]
    n = counters.get("learn.sum_weights")
    if not n:
        return None
    return counters.get("learn.sum_partials", 0.0) / n
