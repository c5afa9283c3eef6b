"""setup.learn_tables_s: seconds in the program's span
``itemgrid.learn_tables`` (``ItemGridEngine.learn_tables`` when it
builds: ``build_learn_tables`` and the upload) over the run's process."""

from gibbsbench import spans


def read(run: dict):
    return spans.total_s(run, ("learning",), "itemgrid.learn_tables")
