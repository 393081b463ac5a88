"""Host ms a replayed window in which the card did nothing: the replays' wall time less the device's busy time, over the windows."""

from twinbench.harness import readers


def read(trace, run):
    return readers.per_unit_ms(sum(run["unit_wall_s"]) - trace.busy_s, run)
