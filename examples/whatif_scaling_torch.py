"""What-if analysis on the PyTorch port: sweep schedulers, topologies AND
carbon knobs in the twin, then search the knob space.

The counterpart of ``examples/whatif_scaling.py``, with its 19 candidates,
its search and its lines (plus ``--device`` and ``--days``).  The
candidates run through the batched scenario engine
(``repro_torch.core.scenarios.evaluate_scenarios``): the host axis is
padded to the largest candidate and every lane is placed in one
``des_place`` launch, then read out.  The scenario optimizer
(``repro_torch.core.optimize``) then searches the same knob space, one
``des_place`` launch a batch of 16 lanes.  Its random draws come from a
CPU ``torch.Generator``, not ``jax.random``, so its search visits other
points than the JAX example's for the same ``key``.

    PYTHONPATH=src python examples/whatif_scaling_torch.py
    PYTHONPATH=src python examples/whatif_scaling_torch.py --device cpu --days 0.5

Without ``--device cpu`` it needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

from repro_torch._device import resolve_device
from repro_torch.core.desim import PLACEMENT_POLICIES
from repro_torch.core.optimize import (
    ObjectiveSpec,
    OptimizeResult,
    OptimizerConfig,
    SearchSpace,
    optimize,
)
from repro_torch.core.scenarios import Scenario, evaluate_scenarios
from repro_torch.traces.carbon import make_diurnal_carbon
from repro_torch.traces.schema import DatacenterConfig
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like

DAYS = 2.0
TOPOLOGIES = (64, 128, 200, 277)


def candidates() -> list[Scenario]:
    """The 19 swept candidates: 4 topologies x 4 policies, then three
    carbon knobs on the full topology."""
    policies = sorted(PLACEMENT_POLICIES)
    out = [Scenario(name=f"{p}-h{h}", policy=p, num_hosts=h,
                    backfill_depth=0 if p == "worst_fit" else 8)
           for h in TOPOLOGIES for p in policies]
    # carbon knobs on the full topology: tighter caps when the grid is
    # dirty, and batch work shifted 3/6 hours toward the midday solar dip
    out += [
        Scenario(name="carbon-cap", carbon_cap_base_w=48_000.0,
                 carbon_cap_slope=-60.0),
        Scenario(name="shift-3h", shift_bins=36),
        Scenario(name="shift-6h", shift_bins=72),
    ]
    return out


#: the search's objective, space and budget
OBJECTIVE = ObjectiveSpec(w_gco2_kg=1.0, w_wait=0.5, w_unplaced=50.0, w_throttled=0.1)
SPACE = SearchSpace(
    structures=tuple(Scenario(name=p, policy=p,
                              backfill_depth=0 if p == "worst_fit" else 8)
                     for p in sorted(PLACEMENT_POLICIES)),
    carbon_cap_base_w=(35_000.0, 80_000.0),
    carbon_cap_slope=(-80.0, 0.0),
    shift_bins=(0, 72))
CONFIG = OptimizerConfig(batch_size=16, generations=3)


def grid_score(s) -> float:
    """The grid's score under the optimizer's objective (carbon candidates
    only have comparable knobs; weight the same terms it minimized)."""
    return (s.gco2 / 1e3 + 0.5 * max(s.mean_wait_bins, 0.0)
            + 50.0 * s.unplaced_jobs + 0.1 * s.cap_exceeded_bins)


@dataclasses.dataclass
class WhatIfResult:
    summaries: list             # ScenarioSummary of each candidate, in order
    winners: dict               # topology -> its policy winner's summary
    search: OptimizeResult


def setup(days: float, device: str = "cuda"):
    """``(workload, datacenter, t_bins, carbon intensity)`` of ``days`` of
    SURF-22 on the full SURF-SARA topology, the workload on ``device``."""
    t_bins = int(days * BINS_PER_DAY)
    base = DatacenterConfig()
    workload = make_surf22_like(SurfTraceSpec(days=days), base,
                                device=resolve_device(device))
    return workload, base, t_bins, make_diurnal_carbon(t_bins)   # [T] gCO2/kWh


def sweep(workload, base, t_bins: int, intensity) -> list:
    """The 19 candidates' summaries, in order."""
    return evaluate_scenarios(workload, base, candidates(), t_bins=t_bins,
                              carbon_intensity=intensity)[3]


def main(argv=None) -> WhatIfResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", type=float, default=DAYS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    workload, base, t_bins, intensity = setup(args.days, args.device)
    summaries = sweep(workload, base, t_bins, intensity)

    print(f"{'scenario':>14s} {'hosts':>6s} {'policy':>11s} {'mean util':>10s} "
          f"{'wait bins':>10s} {'unplaced':>9s} {'energy kWh':>11s} "
          f"{'kgCO2':>8s} {'g/kWh':>6s}")
    for s in summaries:
        # kwh_per_cpu_hour is NaN for an empty workload — surfaced, not
        # hidden behind a clamped denominator; gCO2 would be NaN without an
        # intensity trace.
        print(f"{s.name:>14s} {s.num_hosts:6d} {s.policy:>11s} "
              f"{s.mean_util:10.1%} {s.mean_wait_bins:10.2f} "
              f"{s.unplaced_jobs:9d} {s.energy_kwh:11.1f} "
              f"{s.gco2/1e3:8.1f} {s.carbon_intensity_avg:6.0f}")

    print("\npolicy winner per topology (lowest mean wait, no extra "
          "unplaced jobs vs the topology's best placement count):")
    winners = {}
    for h in TOPOLOGIES:
        group = [s for s in summaries if s.num_hosts == h
                 and s.shift_bins == 0 and s.carbon_cap_base_w is None]
        fewest_unplaced = min(s.unplaced_jobs for s in group)
        viable = [s for s in group if s.unplaced_jobs == fewest_unplaced]
        win = winners[h] = min(viable, key=lambda s: (
            s.mean_wait_bins if math.isfinite(s.mean_wait_bins) else math.inf,
            s.energy_kwh))
        print(f"  h{h:<4d} -> {win.policy} (backfill={win.backfill_depth}): "
              f"wait {win.mean_wait_bins:.2f} bins, "
              f"{win.unplaced_jobs} unplaced, {win.energy_kwh:.1f} kWh, "
              f"{win.gco2/1e3:.1f} kgCO2")

    baseline = next(s for s in summaries
                    if s.name == f"worst_fit-h{base.num_hosts}")
    carbon = [s for s in summaries
              if s.shift_bins != 0 or s.carbon_cap_base_w is not None]
    print("\ncost of carbon (vs worst_fit-h277 baseline "
          f"{baseline.gco2/1e3:.1f} kgCO2):")
    for s in carbon:
        dg = baseline.gco2 - s.gco2
        dwait = s.mean_wait_bins - baseline.mean_wait_bins
        # a shift that pushes tail jobs past the horizon is not a free
        # carbon win — the unplaced delta prices the lost work honestly
        print(f"  {s.name:>12s}: {s.gco2/1e3:8.1f} kgCO2 "
              f"({dg/max(baseline.gco2, 1e-9):+.1%}), "
              f"wait {s.mean_wait_bins:.2f} bins ({dwait:+.2f}), "
              f"{s.unplaced_jobs - baseline.unplaced_jobs:+d} unplaced, "
              f"{s.cap_exceeded_bins} cap-limited bins")

    # -- the optimizer searches what the grid only samples -------------------
    res = optimize(workload, base, SPACE, OBJECTIVE, t_bins=t_bins,
                   carbon_intensity=intensity, key=0, config=CONFIG)
    grid_win = min((s for s in summaries
                    if math.isfinite(s.mean_wait_bins)), key=grid_score)
    b = res.best_summary
    print(f"\nsearched optimum (objective: gCO2 + 0.5*wait + 50*unplaced "
          f"+ 0.1*throttled bins; {res.candidates} candidates, "
          f"{res.batches} batches):")
    print(f"  swept grid best : {grid_win.name:>14s}  "
          f"score {grid_score(grid_win):9.1f}  "
          f"({grid_win.gco2/1e3:.1f} kgCO2, wait "
          f"{grid_win.mean_wait_bins:.2f})")
    cap = ("none" if b.carbon_cap_base_w is None else
           f"{b.carbon_cap_base_w/1e3:.1f}kW{b.carbon_cap_slope:+.0f}")
    print(f"  searched optimum: {b.policy}/bf={b.backfill_depth} "
          f"cap={cap} shift={b.shift_bins}  "
          f"objective {res.best.objective:9.1f}  "
          f"({b.gco2/1e3:.1f} kgCO2, wait {b.mean_wait_bins:.2f}) "
          f"vs baseline {res.baseline.objective:.1f}")

    print("\nReading: fewer hosts -> higher utilization and queueing but "
          "less idle energy;\npacking policies + backfill trade spread for "
          "wait time; carbon caps and time\nshifts buy gCO2 with wait-time "
          "currency — the optimizer *searches* that\ntrade-space and the "
          "twin prices it before any hardware moves (HITL decides).")
    return WhatIfResult(summaries, winners, res)


if __name__ == "__main__":
    main()
