"""SLO-aware feedback with a human-in-the-loop gate (port of ``repro.core.feedback``).

The twin emits proposals and never touches the physical twin directly;
major changes need explicit human approval.  The rules: the closed
loop's (:func:`propose_from_state`), the what-if engine's
(:func:`propose_from_scenario`) and the scenario optimizer's
(:func:`propose_from_optimum`).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.scenarios import ScenarioSummary


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


def propose_from_scenario(
    window: int,
    summary: "ScenarioSummary",
    baseline: "ScenarioSummary",
    *,
    queue_tolerance: float = 1.5,
    min_energy_saving_frac: float = 0.02,
    min_wait_improvement_frac: float = 0.10,
    max_energy_regression_frac: float = 0.02,
    min_carbon_saving_frac: float = 0.02,
    min_cost_saving_frac: float = 0.02,
) -> list[Proposal]:
    """Map a batched what-if candidate's summary to operator proposals.

    The scenario engine (``repro_torch.core.scenarios``) evaluates S candidates
    against the calibrated twin; each candidate that *dominates* the baseline
    on a sustainability metric without breaking SLOs becomes a proposal for
    the HITL gate — the twin recommends, the human decides (paper stage 3).

    Scheduler changes: a candidate on the *same topology* whose placement
    policy or backfill depth differs from the baseline's becomes a
    SCHEDULER_CHANGE proposal when it places at least as many jobs, cuts
    mean queue wait by ``min_wait_improvement_frac`` (or places strictly
    more jobs), and costs at most ``max_energy_regression_frac`` extra
    energy — software-only wins surface before any hardware moves.

    Carbon: when the sweep ran against a grid carbon-intensity trace (both
    ``gco2`` fields finite), a candidate that cuts total gCO2 by at least
    ``min_carbon_saving_frac`` without breaking SLOs becomes a
    CARBON_REDUCTION proposal naming the knob that did it (time shift,
    carbon-aware cap, or topology) — the carbon-driven action the HITL gate
    exists to approve.

    Cost: when the sweep ran against an electricity spot-price trace (both
    ``energy_cost`` fields set), a candidate that cuts the bill by at least
    ``min_cost_saving_frac`` without breaking SLOs becomes a COST_REDUCTION
    proposal — cost and carbon rules fire independently, so a candidate
    that wins on both surfaces twice, each with its own evidence.

    Resilience: a candidate evaluated *under failure windows*
    (``failure_events > 0``) that still meets the baseline's SLOs becomes a
    RESILIENCE proposal — evidence the current configuration rides out the
    modeled outages/drains without operator action.
    """
    out: list[Proposal] = []
    slo_ok = (
        summary.unplaced_jobs <= baseline.unplaced_jobs
        and summary.p99_queue <= max(baseline.p99_queue * queue_tolerance,
                                     baseline.p99_queue + 5.0)
    )
    saving = baseline.energy_kwh - summary.energy_kwh
    if (slo_ok and summary.num_hosts < baseline.num_hosts
            and saving > min_energy_saving_frac * max(baseline.energy_kwh, 1e-9)):
        out.append(Proposal(
            ProposalKind.SCALE_DOWN_IDLE, window,
            f"what-if '{summary.name}': {summary.num_hosts} hosts "
            f"(vs {baseline.num_hosts}) saves {saving:.1f} kWh "
            f"({saving / max(baseline.energy_kwh, 1e-9):.1%}) with "
            f"p99 queue {summary.p99_queue:.0f} and "
            f"{summary.unplaced_jobs} unplaced jobs",
            impact={"scenario": summary.name, "num_hosts": summary.num_hosts,
                    "energy_saving_kwh": saving,
                    "p99_queue": summary.p99_queue}))
    if (summary.num_hosts > baseline.num_hosts
            and baseline.unplaced_jobs > 0
            and summary.unplaced_jobs < baseline.unplaced_jobs):
        out.append(Proposal(
            ProposalKind.SCALE_UP, window,
            f"what-if '{summary.name}': {summary.num_hosts} hosts places "
            f"{baseline.unplaced_jobs - summary.unplaced_jobs} more jobs "
            f"(baseline leaves {baseline.unplaced_jobs} unplaced)",
            impact={"scenario": summary.name, "num_hosts": summary.num_hosts,
                    "unplaced_jobs": summary.unplaced_jobs}))
    same_topology = (summary.num_hosts == baseline.num_hosts
                     and summary.cores_per_host == baseline.cores_per_host)
    scheduler_differs = (summary.policy != baseline.policy
                         or summary.backfill_depth != baseline.backfill_depth)
    if same_topology and scheduler_differs:
        places_more = summary.unplaced_jobs < baseline.unplaced_jobs
        # NaN-safe: a NaN baseline wait (nothing started) never qualifies.
        wait_cut = baseline.mean_wait_bins - summary.mean_wait_bins
        wait_improves = (
            wait_cut > min_wait_improvement_frac
            * max(baseline.mean_wait_bins, 1.0))
        energy_ok = (summary.energy_kwh <= baseline.energy_kwh
                     * (1.0 + max_energy_regression_frac))
        if (summary.unplaced_jobs <= baseline.unplaced_jobs and energy_ok
                and (places_more or wait_improves)):
            out.append(Proposal(
                ProposalKind.SCHEDULER_CHANGE, window,
                f"what-if '{summary.name}': switch scheduler to "
                f"{summary.policy}/backfill={summary.backfill_depth} "
                f"(from {baseline.policy}/backfill={baseline.backfill_depth}): "
                f"mean wait {summary.mean_wait_bins:.1f} bins "
                f"(vs {baseline.mean_wait_bins:.1f}), "
                f"{summary.unplaced_jobs} unplaced "
                f"(vs {baseline.unplaced_jobs}), "
                f"energy {summary.energy_kwh:.1f} kWh "
                f"(vs {baseline.energy_kwh:.1f})",
                impact={"scenario": summary.name, "policy": summary.policy,
                        "backfill_depth": summary.backfill_depth,
                        "mean_wait_bins": summary.mean_wait_bins,
                        "unplaced_jobs": summary.unplaced_jobs,
                        "energy_kwh": summary.energy_kwh}))
    # carbon-driven actions: only comparable when both ran with a trace
    g_base, g_cand = baseline.gco2, summary.gco2
    if (math.isfinite(g_base) and math.isfinite(g_cand) and slo_ok
            and g_base - g_cand > min_carbon_saving_frac * max(g_base, 1e-9)):
        knobs = []
        if summary.shift_bins != baseline.shift_bins:
            knobs.append(f"shift deferrable jobs by {summary.shift_bins} bins")
        if summary.carbon_cap_base_w is not None:
            knobs.append(
                f"carbon-aware cap {summary.carbon_cap_base_w/1e3:.1f} kW "
                f"{summary.carbon_cap_slope:+.1f} W/(gCO2/kWh)")
        if summary.num_hosts != baseline.num_hosts:
            knobs.append(f"{summary.num_hosts} hosts")
        out.append(Proposal(
            ProposalKind.CARBON_REDUCTION, window,
            f"what-if '{summary.name}': {', '.join(knobs) or 'candidate'} "
            f"cuts carbon to {g_cand/1e3:.1f} kgCO2 "
            f"(vs {g_base/1e3:.1f}, -{(g_base - g_cand)/max(g_base,1e-9):.1%}) "
            f"at {summary.energy_kwh:.1f} kWh (vs {baseline.energy_kwh:.1f})",
            impact={"scenario": summary.name,
                    "gco2": g_cand,
                    "gco2_saving": g_base - g_cand,
                    "shift_bins": summary.shift_bins,
                    "carbon_cap_base_w": summary.carbon_cap_base_w,
                    "energy_kwh": summary.energy_kwh}))
    # cost-driven actions: only comparable when both lanes were priced
    c_base, c_cand = baseline.energy_cost, summary.energy_cost
    if (c_base is not None and c_cand is not None
            and math.isfinite(c_base) and math.isfinite(c_cand) and slo_ok
            and c_base - c_cand > min_cost_saving_frac * max(abs(c_base), 1e-9)):
        knobs = []
        if summary.shift_bins != baseline.shift_bins:
            knobs.append(f"shift deferrable jobs by {summary.shift_bins} bins")
        if summary.power_cap_w is not None:
            knobs.append(f"cap {summary.power_cap_w/1e3:.1f} kW")
        if summary.carbon_cap_base_w is not None:
            knobs.append(
                f"carbon-aware cap {summary.carbon_cap_base_w/1e3:.1f} kW "
                f"{summary.carbon_cap_slope:+.1f} W/(gCO2/kWh)")
        if summary.num_hosts != baseline.num_hosts:
            knobs.append(f"{summary.num_hosts} hosts")
        out.append(Proposal(
            ProposalKind.COST_REDUCTION, window,
            f"what-if '{summary.name}': {', '.join(knobs) or 'candidate'} "
            f"cuts energy cost to ${c_cand:.2f} (vs ${c_base:.2f}, "
            f"-{(c_base - c_cand)/max(abs(c_base), 1e-9):.1%}) at "
            f"{summary.energy_kwh:.1f} kWh (vs {baseline.energy_kwh:.1f})",
            impact={"scenario": summary.name,
                    "energy_cost": c_cand,
                    "cost_saving": c_base - c_cand,
                    "shift_bins": summary.shift_bins,
                    "energy_kwh": summary.energy_kwh}))
    # resilience: the candidate was stress-tested under failure windows and
    # still meets the baseline's SLOs — worth surfacing to the operator.
    if summary.failure_events > 0 and slo_ok:
        out.append(Proposal(
            ProposalKind.RESILIENCE, window,
            f"what-if '{summary.name}' rides out {summary.failure_events} "
            f"host failure window(s): {summary.unplaced_jobs} unplaced "
            f"(baseline {baseline.unplaced_jobs}), p99 queue "
            f"{summary.p99_queue:.0f} (baseline {baseline.p99_queue:.0f})",
            impact={"scenario": summary.name,
                    "failure_events": summary.failure_events,
                    "unplaced_jobs": summary.unplaced_jobs,
                    "p99_queue": summary.p99_queue}))
    cap = summary.power_cap_w
    carbon_capped = summary.carbon_cap_base_w is not None
    if ((carbon_capped or (cap is not None and math.isfinite(cap)))
            and summary.cap_exceeded_bins > 0):
        cap_desc = (f"{cap/1e3:.1f} kW" if cap is not None
                    else f"carbon-aware <= {summary.carbon_cap_base_w/1e3:.1f} kW")
        out.append(Proposal(
            ProposalKind.POWER_CAP, window,
            f"what-if '{summary.name}': demand runs into cap {cap_desc} "
            f"in {summary.cap_exceeded_bins} bins "
            f"(peak demand {summary.peak_demand_w/1e3:.1f} kW, "
            f"delivered peak {summary.peak_power_w/1e3:.1f} kW)",
            impact={"scenario": summary.name,
                    "cap_exceeded_bins": summary.cap_exceeded_bins,
                    "peak_power_w": summary.peak_power_w,
                    "peak_demand_w": summary.peak_demand_w}))
    return out


def propose_from_optimum(
    window: int,
    summary: "ScenarioSummary",
    baseline: "ScenarioSummary",
    *,
    objective: float,
    baseline_objective: float,
    breakdown: dict,
    baseline_breakdown: dict,
    **thresholds,
) -> list[Proposal]:
    """Route a *searched* operating point through the proposal rules.

    The scenario optimizer (:mod:`repro_torch.core.optimize`) hands the winning
    candidate here with its scalarized objective breakdown; every proposal
    the ordinary what-if rules emit for it
    (:func:`propose_from_scenario`, ``thresholds`` forwarded) gains the
    search provenance an approver needs: the winner's objective vs the
    baseline's and the per-term breakdown (gCO2, energy, SLO penalties).

    When the searched optimum improves the objective but trips none of the
    threshold-based rules (savings below the per-metric thresholds, or
    spread across several metrics), a CARBON_REDUCTION proposal is emitted
    anyway — the whole point of searching is that the optimizer may land on
    an operating point no single-metric rule would have flagged.  A winner
    identical to the baseline configuration proposes nothing.
    """
    out = propose_from_scenario(window, summary, baseline, **thresholds)
    improved = (math.isfinite(objective)
                and objective < baseline_objective)
    same_config = (
        summary.num_hosts == baseline.num_hosts
        and summary.cores_per_host == baseline.cores_per_host
        and summary.policy == baseline.policy
        and summary.backfill_depth == baseline.backfill_depth
        and summary.shift_bins == baseline.shift_bins
        and summary.power_cap_w == baseline.power_cap_w
        and summary.carbon_cap_base_w == baseline.carbon_cap_base_w
        and summary.carbon_cap_slope == baseline.carbon_cap_slope
        and summary.failure_events == baseline.failure_events)
    if not out and improved and not same_config:
        knobs = []
        if summary.policy != baseline.policy or \
                summary.backfill_depth != baseline.backfill_depth:
            knobs.append(f"scheduler {summary.policy}"
                         f"/backfill={summary.backfill_depth}")
        if summary.num_hosts != baseline.num_hosts:
            knobs.append(f"{summary.num_hosts} hosts")
        if summary.cores_per_host != baseline.cores_per_host:
            knobs.append(f"{summary.cores_per_host} cores/host")
        if summary.shift_bins != baseline.shift_bins:
            knobs.append(f"shift deferrable jobs by {summary.shift_bins} bins")
        if summary.power_cap_w is not None:
            knobs.append(f"cap {summary.power_cap_w/1e3:.1f} kW")
        if summary.carbon_cap_base_w is not None:
            knobs.append(
                f"carbon-aware cap {summary.carbon_cap_base_w/1e3:.1f} kW "
                f"{summary.carbon_cap_slope:+.1f} W/(gCO2/kWh)")
        # pick the kind from the breakdown: a winner whose gain is dollars
        # (cost down, carbon flat or worse) is a COST_REDUCTION; everything
        # else keeps the historical CARBON_REDUCTION label.
        def _gain(key):
            try:
                return (float(baseline_breakdown.get(key))
                        - float(breakdown.get(key)))
            except (TypeError, ValueError):
                return math.nan
        cost_gain = _gain("energy_cost")
        carbon_gain = _gain("gco2_kg")
        kind = (ProposalKind.COST_REDUCTION
                if math.isfinite(cost_gain) and cost_gain > 0
                and (not math.isfinite(carbon_gain) or carbon_gain <= 0)
                else ProposalKind.CARBON_REDUCTION)
        out.append(Proposal(
            kind, window,
            f"searched optimum '{summary.name}': "
            f"{', '.join(knobs) or 'candidate'} "
            f"improves the operating objective to {objective:.3f} "
            f"(vs baseline {baseline_objective:.3f})",
            impact={"scenario": summary.name}))
    for p in out:
        p.impact["objective"] = objective
        p.impact["objective_baseline"] = baseline_objective
        p.impact["objective_breakdown"] = dict(breakdown)
        p.impact["objective_breakdown_baseline"] = dict(baseline_breakdown)
        p.impact["searched_optimum"] = summary.name
    return out
