"""Host-failure schedules for the DES (port of ``repro.runtime.fault``).

A tuple of per-host outage/degradation windows becomes three dense
``[max_hosts]`` arrays (start, end, kill flag) that the DES folds into a
time-varying host mask, so "rack 3 dies at noon" is one lane of a what-if
batch.  The JAX module's training restart loop (``run_with_restarts``)
is not ported here: it waits for the training path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: schedule sentinel for "this host never fails": the window start sits
#: past any representable bin, so every ``start <= t < end`` test is false
NEVER_BIN = np.iinfo(np.int32).max

#: failure kinds: an OUTAGE kills running jobs and draws no power for the
#: window; a DEGRADED host drains (no new placements, running jobs finish,
#: the host keeps drawing power).
OUTAGE = "outage"
DEGRADED = "degraded"


@dataclasses.dataclass(frozen=True)
class HostFailure:
    """One per-host failure window ``[start_bin, end_bin)`` on the DES clock.

    ``kind="outage"``: jobs running on the host at ``start_bin`` are
    killed (their cores come back with the host at ``end_bin``), and the
    host takes no placements and draws no power during the window.
    ``kind="degraded"``: no new placements during the window; running jobs
    keep running and the host keeps drawing power.
    """

    host: int
    start_bin: int
    end_bin: int
    kind: str = OUTAGE

    def __post_init__(self):
        if self.host < 0:
            raise ValueError(f"failure host must be >= 0, got {self.host}")
        if not 0 <= self.start_bin < self.end_bin:
            raise ValueError(
                f"failure window must satisfy 0 <= start < end, got "
                f"[{self.start_bin}, {self.end_bin})")
        if self.kind not in (OUTAGE, DEGRADED):
            raise ValueError(
                f"failure kind must be {OUTAGE!r} or {DEGRADED!r}, "
                f"got {self.kind!r}")


def failure_arrays(failures, max_hosts: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``[max_hosts]`` (start int32, end int32, kill bool) arrays.

    Hosts without a window get the ``NEVER_BIN`` start (and end 0), so a
    lane without failures in a mixed batch runs the no-failure schedule.
    One window per host: overlapping schedules must be merged first.
    """
    fs = np.full(max_hosts, NEVER_BIN, np.int32)
    fe = np.zeros(max_hosts, np.int32)
    kill = np.zeros(max_hosts, bool)
    for f in failures:
        if f.host >= max_hosts:
            raise ValueError(
                f"failure host {f.host} out of range for {max_hosts} hosts")
        if fs[f.host] != NEVER_BIN:
            raise ValueError(
                f"host {f.host} has multiple failure windows; the DES "
                "carries one window per host — merge them first")
        fs[f.host] = f.start_bin
        fe[f.host] = f.end_bin
        kill[f.host] = f.kind == OUTAGE
    return fs, fe, kill
