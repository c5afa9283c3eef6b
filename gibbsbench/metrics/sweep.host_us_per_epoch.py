"""sweep.host_us_per_epoch: the host's own time in the sweep launch
loop, the self time of the program's span ``itemgrid.run``
(``ItemGridEngine.run``: its arguments and launches; a first call's
kernel load is a child span and not counted) over the counter
``inference.epochs``, over the run's process, in microseconds."""

from gibbsbench import spans


def read(run: dict):
    return spans.self_us_per_epoch(run, "inference", "itemgrid.run",
                                   "inference.epochs")
