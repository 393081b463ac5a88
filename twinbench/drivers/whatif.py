"""What-if sweeps: one operator's closed loop of requests through
``repro_torch.core.scenarios.evaluate_scenarios``.

A request is the traffic's grid of scenarios (lanes) over one week of the
configuration's datacenter; requests cycle over a pool of weeks made from
the seed in set-up.  The output check takes a seeded sample of the requests
finished in the window and of their lanes, and works each lane out again
with :mod:`twinbench.reference.whatif`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from twinbench.drivers import common
from twinbench.harness import device as dev_mod
from twinbench.harness import grid, report, seeds, surf22, trace
from twinbench.reference import whatif as ref

def lanes_of(traffic: dict) -> list[dict]:
    return grid.expand(traffic["axes"])


def scenarios_of(lanes: list[dict]) -> list:
    from repro_torch.core.scenarios import Scenario
    from repro_torch.runtime.fault import HostFailure
    out = []
    for i, ln in enumerate(lanes):
        fails = tuple(HostFailure(h, w["start_bin"], w["end_bin"], w["kind"])
                      for w in ln["failures"] for h in range(*w["hosts"]))
        out.append(Scenario(name=f"lane{i}", num_hosts=ln["num_hosts"], policy=ln["policy"],
                            backfill_depth=ln["backfill_depth"], failures=fails,
                            power_cap_w=ln["power_cap_w"]))
    return out


def run(cell, *, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> common.Outcome:
    import torch
    from repro_torch.core.power import PowerParams
    from repro_torch.core.scenarios import evaluate_scenarios
    from repro_torch.traces.schema import DatacenterConfig

    cfg, tr = cell.config, cell.traffic
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    common.build_kernels(device, tr["kernels"])
    phases["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    dc = DatacenterConfig(**cfg["datacenter"])
    base = PowerParams(**cfg["base_params"])
    lanes = lanes_of(tr)
    scenarios = scenarios_of(lanes)
    weeks = [surf22.make_week(cfg["trace"], cfg["datacenter"], seeds.derive(seed, seeds.WEEKS, i))
             for i in range(tr["pool_weeks"])]
    pool = [common.workload(torch, w, device) for w in weeks]
    t_bins = weeks[0]["t_bins"]
    phases["weeks"] = time.perf_counter() - t

    def request(n):
        with torch.profiler.record_function("whatif.evaluate_scenarios"):
            return evaluate_scenarios(pool[n % len(pool)], dc, scenarios, t_bins=t_bins,
                                      base_params=base,
                                      max_starts_per_bin=tr["max_starts_per_bin"])

    t = time.perf_counter()
    for n in range(len(pool)):          # warm-up: every week of the pool once
        request(n)
    common.sync(torch, device)
    phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    kept = grid.Reservoir(tr["check"]["requests"], seeds.rng(seed, seeds.SAMPLE))

    def keep(n, out):
        _, sim, pred, summaries = out
        kept.offer((n, sim.job_start, sim.job_host,
                    {k: getattr(pred, k) for k in ref.PRED_LEAVES}, summaries))

    sink = []
    with trace.traced(torch, traced, sink):
        count, elapsed, walls = common.closed_loop(seconds, request, keep)
    peak = dev_mod.memory_peak(torch, device)
    del pool
    if device.type == "cuda":
        torch.cuda.empty_cache()

    s = len(lanes)
    t_check = time.perf_counter()
    checks = check(kept.items, weeks, lanes, cfg, tr, seed)
    check_s = time.perf_counter() - t_check
    metrics = {"whatif_scenarios_per_s": count * s / elapsed,
               "whatif_p95_ms": float(np.percentile(walls, 95)) * 1e3,
               "setup_s": setup_s}
    launches = {"des_place": [dict(lanes=s, bins=t_bins, hosts=max(ln["num_hosts"] for ln in lanes),
                                   jobs=int(weeks[n % len(weeks)]["submit"].shape[0]))
                              for n in range(count)]}
    return common.Outcome(metrics=metrics, attempted=count, failed=0, checks=checks,
                          memory_peak_bytes=peak, trace=sink[0] if sink else None,
                          run={"units": count, "launches": launches, "unit_wall_s": walls,
                               "check_s": check_s, "setup_phases": phases})


def served(item, lane_idx: int) -> dict:
    """Lane ``lane_idx`` of a kept request, on the host."""
    _, job_start, job_host, pred, summaries = item
    return dict(job_start=job_start[lane_idx].cpu().numpy(),
                job_host=job_host[lane_idx].cpu().numpy(),
                pred={k: v[lane_idx].double().cpu().numpy() for k, v in pred.items()},
                summary=dataclasses.asdict(summaries[lane_idx]))


def check(items: list, weeks: list, lanes: list, cfg: dict, tr: dict, seed: int,
          control=None) -> report.Checks:
    """Hold a seeded sample of lanes of the kept requests against the
    reference.  With ``control`` (a dtype), the reference computed in that
    precision takes the served prediction's place."""
    limits = tr["check"]["limits"]
    rng = seeds.rng(seed, seeds.SAMPLE + 100)
    worst = dict(placement_mismatches=0, prediction_rel_gap=0.0, summary_rel_gap=0.0,
                 summary_count_mismatches=0)
    setw = dict(dc=cfg["datacenter"], max_hosts=max(ln["num_hosts"] for ln in lanes),
                max_backfill=max(ln["backfill_depth"] for ln in lanes),
                any_failures=any(ln["failures"] for ln in lanes),
                max_starts=tr["max_starts_per_bin"])
    checked = 0
    for item in sorted(items, key=lambda x: x[0]):
        week = weeks[item[0] % len(weeks)]
        picks = rng.choice(len(lanes), size=tr["check"]["lanes_per_request"], replace=False)
        for li in sorted(int(x) for x in picks):
            lane = lanes[li]
            sched = ref.schedule(week, lane, **setw)
            pred = ref.prediction(sched, lane, dc=cfg["datacenter"], base=cfg["base_params"])
            want = dict(job_start=sched["job_start"], job_host=sched["job_host"], pred=pred,
                        summary=ref.summary(week, lane, sched["job_start"], sched["queue"], pred))
            if control is None:
                got = served(item, li)
            else:
                cpred = ref.prediction(sched, lane, dc=cfg["datacenter"],
                                       base=cfg["base_params"], dtype=control)
                got = dict(job_start=sched["job_start"], job_host=sched["job_host"], pred=cpred,
                           summary=ref.summary(week, lane, sched["job_start"], sched["queue"],
                                               cpred))
            for k, v in ref.compare(got, want, lane, tie=limits["prediction_rel_gap"]).items():
                worst[k] = max(worst[k], v)
            checked += 1
    checks = report.Checks()
    for k, v in worst.items():
        checks.add(k, v, limits[k])
    checks.add("lanes_short", max(0, tr["check"]["requests"] * tr["check"]["lanes_per_request"]
                                  - checked), 0)
    return checks
