"""calib_mape_grid's roofline share: its bound (twinbench/counts/calib_mape.py) over its device time, in %."""

from twinbench.harness import readers


def read(trace, run):
    return readers.roofline_percent(trace, run, "calib_mape", "calib_mape")
