"""SLO-aware feedback with a human-in-the-loop gate (port of ``repro.core.feedback``).

The twin emits proposals and never touches the physical twin directly;
major changes need explicit human approval.  Only the rules the closed
loop uses are ported here (:func:`propose_from_state`); the what-if and
optimizer rules come with those slices.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable


class ProposalKind(enum.Enum):
    RECALIBRATE = "recalibrate"            # minor: applied automatically
    POWER_CAP = "power_cap"                # major: needs approval
    SCALE_DOWN_IDLE = "scale_down_idle"    # major
    SCALE_UP = "scale_up"                  # major
    RESTART_STRAGGLER = "restart_straggler"  # major
    REBALANCE = "rebalance"                # major
    SCHEDULER_CHANGE = "scheduler_change"  # major
    CARBON_REDUCTION = "carbon_reduction"  # major
    COST_REDUCTION = "cost_reduction"      # major
    RESILIENCE = "resilience"              # major


#: proposal kinds applied without a human (minor changes)
MINOR = {ProposalKind.RECALIBRATE}


@dataclasses.dataclass
class Proposal:
    kind: ProposalKind
    window: int
    detail: str
    impact: dict = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)
    approved: bool | None = None    # None = pending
    applied: bool = False


class HITLGate:
    """Approval queue between the twin and the physical ICT.

    ``policy`` decides pending proposals when :meth:`drain` runs; without
    one everything major stays pending until a human approves or rejects.
    """

    def __init__(self, policy: Callable[[Proposal], bool | None] | None = None):
        self.policy = policy
        self.queue: list[Proposal] = []
        self.log: list[Proposal] = []

    def submit(self, p: Proposal) -> Proposal:
        if p.kind in MINOR:
            p.approved = True
        self.queue.append(p)
        return p

    def approve(self, idx: int) -> None:
        self.queue[idx].approved = True

    def reject(self, idx: int) -> None:
        self.queue[idx].approved = False

    def pending(self) -> list[Proposal]:
        return [p for p in self.queue if p.approved is None]

    def drain(self) -> list[Proposal]:
        """Resolve with the policy; return newly approved, unapplied ones."""
        out = []
        for p in self.queue:
            if p.approved is None and self.policy is not None:
                p.approved = self.policy(p)
            if p.approved and not p.applied:
                p.applied = True
                out.append(p)
        self.log.extend(out)
        self.queue = [p for p in self.queue if p.approved is None]
        return out


def propose_from_state(window: int, *, mape: float | None,
                       mean_util: float, queue_len: float,
                       power_w: float, power_cap_w: float | None) -> list[Proposal]:
    """Rule set mapping twin state to operator proposals (paper §3.3)."""
    out: list[Proposal] = []
    if mape is not None and mape > 10.0:
        out.append(Proposal(
            ProposalKind.RECALIBRATE, window,
            f"window MAPE {mape:.2f}% breaches NFR1 threshold; recalibrate",
            impact={"mape": mape}))
    if mean_util < 0.30 and queue_len < 1:
        out.append(Proposal(
            ProposalKind.SCALE_DOWN_IDLE, window,
            f"mean utilization {mean_util:.1%} with empty queue; "
            "idle hosts could be powered down",
            impact={"mean_util": mean_util}))
    if queue_len > 50:
        out.append(Proposal(
            ProposalKind.SCALE_UP, window,
            f"queue length {queue_len:.0f}; capacity expansion advised",
            impact={"queue_len": queue_len}))
    if power_cap_w is not None and power_w > power_cap_w:
        out.append(Proposal(
            ProposalKind.POWER_CAP, window,
            f"predicted draw {power_w/1e3:.1f} kW exceeds cap "
            f"{power_cap_w/1e3:.1f} kW",
            impact={"power_w": power_w}))
    return out
