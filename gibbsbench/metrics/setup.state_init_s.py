"""setup.state_init_s: seconds in the program's span ``state_init``
(``FactorGraph.__init__``'s ``init_state``: the first allocation on the
card, the CUDA context with it, and the sampler state's upload) over the
run's process."""

from gibbsbench import spans


def read(run: dict):
    return spans.total_s(run, spans.SETUP, "state_init")
