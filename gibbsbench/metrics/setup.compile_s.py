"""setup.compile_s: seconds in the program's span ``compile``
(``compile.compile_graph``, its plan-cache lookup included) over the
run's process."""

from gibbsbench import spans


def read(run: dict):
    return spans.total_s(run, spans.SETUP, "compile")
