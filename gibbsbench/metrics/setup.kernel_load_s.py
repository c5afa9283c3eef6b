"""setup.kernel_load_s: seconds in the program's span ``kernels.load``
(``ops/_build.load_library`` on its uncached path: nvcc when the library
is not built yet, then dlopen) over the run's process."""

from gibbsbench import spans


def read(run: dict):
    return spans.total_s(run, spans.SETUP, "kernels.load")
