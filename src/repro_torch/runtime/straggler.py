"""Straggler detection driven by the twin's step-time expectation
(port of ``repro.runtime.straggler``).

Hosts whose reported step times sit far above an EWMA-calibrated
expectation get flagged; the runtime proposes RESTART_STRAGGLER through
the HITL gate, and :func:`degradation_from_stragglers` turns those
proposals into drain windows the what-if DES can consume.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.feedback import Proposal, ProposalKind
from repro_torch.runtime.fault import DEGRADED, HostFailure


@dataclasses.dataclass
class StragglerConfig:
    ewma: float = 0.1               # calibration rate for expected step time
    threshold: float = 1.35         # flag hosts slower than 1.35x expectation
    min_samples: int = 8            # warmup before flagging
    hysteresis: int = 3             # consecutive slow windows before proposal


class StragglerDetector:
    def __init__(self, num_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.expected: float | None = None       # calibrated step seconds
        self.samples = 0
        self.slow_streak = np.zeros(num_hosts, np.int32)

    def observe(self, step_seconds_per_host: np.ndarray, window: int
                ) -> list[Proposal]:
        """Per-host step durations for one window -> straggler proposals."""
        t = np.asarray(step_seconds_per_host, np.float64)
        med = float(np.median(t))
        if self.expected is None:
            self.expected = med
        else:
            self.expected = ((1 - self.cfg.ewma) * self.expected
                             + self.cfg.ewma * med)
        self.samples += 1
        if self.samples < self.cfg.min_samples:
            return []
        slow = t > self.cfg.threshold * self.expected
        self.slow_streak = np.where(slow, self.slow_streak + 1, 0)
        out = []
        for h in np.nonzero(self.slow_streak >= self.cfg.hysteresis)[0]:
            out.append(Proposal(
                ProposalKind.RESTART_STRAGGLER, window,
                f"host {h}: {t[h]:.2f}s/step vs calibrated "
                f"{self.expected:.2f}s ({t[h]/self.expected:.2f}x) for "
                f"{int(self.slow_streak[h])} windows",
                impact={"host": int(h), "ratio": float(t[h] / self.expected)},
            ))
            self.slow_streak[h] = 0               # proposal in flight
        return out


def degradation_from_stragglers(proposals, *, start_bin: int,
                                duration_bins: int) -> tuple[HostFailure, ...]:
    """Straggler proposals -> DEGRADED failure windows for the what-if DES.

    Each RESTART_STRAGGLER proposal becomes a drain window starting at
    ``start_bin``; duplicate hosts collapse to one window (the DES carries
    one per host).
    """
    hosts = []
    for p in proposals:
        if p.kind is not ProposalKind.RESTART_STRAGGLER:
            continue
        h = int(p.impact["host"])
        if h not in hosts:
            hosts.append(h)
    return tuple(
        HostFailure(h, start_bin, start_bin + duration_bins, kind=DEGRADED)
        for h in hosts)
