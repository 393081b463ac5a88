"""Device-busy ms a what-if request outside the des_place kernel: the eager readout, the prediction and the copies the summaries take."""

from twinbench.harness import readers


def read(trace, run):
    return readers.per_unit_ms(trace.busy_s - trace.kernel_s("des_place_kernel"), run)
