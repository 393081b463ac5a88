"""des_place's roofline share: its bound (twinbench/counts/des_place.py) over its device time, in %."""

from twinbench.harness import readers


def read(trace, run):
    return readers.roofline_percent(trace, run, "des_place", "des_place_kernel")
