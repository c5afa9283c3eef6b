"""setup.engine_build_s: seconds in the program's span ``itemgrid.build``
(``ItemGridEngine.__init__``: the schedule, ``build_tables`` and the
tables' upload) over the run's process."""

from gibbsbench import spans


def read(run: dict):
    return spans.total_s(run, spans.SETUP, "itemgrid.build")
