"""The work of each kernel, fixed by the inputs alone: the roofline's
operation and byte counts.  A kernel's bound is the larger of its operations
over the f32 peak and its bytes over the HBM peak
(:mod:`twinbench.harness.device`); each input byte is read once and each
output byte written once.  Any implementation of a kernel is read against
the same work, whatever it computes twice or skips."""
