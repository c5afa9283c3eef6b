"""learn.host_us_per_epoch: the host's own time in the learning launch
loop, the self time of the program's span ``itemgrid.learn``
(``ItemGridEngine.learn``: its arguments and launches; a first call's
kernel load is a child span and not counted) over the counter
``learning.epochs``, over the run's process, in microseconds."""

from gibbsbench import spans


def read(run: dict):
    return spans.self_us_per_epoch(run, "learning", "itemgrid.learn",
                                   "learning.epochs")
