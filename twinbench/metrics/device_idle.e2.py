"""Share of the traced replay window in which no kernel or copy ran on the card, in %."""

from twinbench.harness import readers


def read(trace, run):
    return readers.idle_percent(trace)
