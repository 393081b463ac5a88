"""Device ms of the calib_mape_grid kernels (both passes) a replayed window."""

from twinbench.harness import readers


def read(trace, run):
    return readers.per_unit_ms(trace.kernel_s("calib_mape"), run)
