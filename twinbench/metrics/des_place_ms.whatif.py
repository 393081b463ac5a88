"""Device ms of the des_place kernel a what-if request."""

from twinbench.harness import readers


def read(trace, run):
    return readers.per_unit_ms(trace.kernel_s("des_place_kernel"), run)
