"""The twin's trace replay (the paper's E2): one operator replays weeks back
to back through ``repro_torch.core.twin.DigitalTwin``.

A request is one week replayed at maximum acceleration: a twin built over
the week's workload, whose DES runs inside the request as a replay pays it,
then each window's telemetry ingested and twinned in turn (predicted,
scored against the measured power and re-calibrated).  Requests cycle over
a pool of weeks made from the seed in set-up, each with its observed
utilization (the port's DES on the card) and its hidden-model power.  The
output check follows a seeded sample of the finished replays through every
window with :mod:`twinbench.reference.twin`.
"""

from __future__ import annotations

import time

import numpy as np

from twinbench.drivers import common
from twinbench.harness import device as dev_mod
from twinbench.harness import grid, report, seeds, surf22, trace
from twinbench.reference import twin as ref

STATE_COUNTS = ("hist_n", "window", "slo_samples", "slo_compliant", "bias_under",
                "bias_over", "bias_ties")


def run(cell, *, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> common.Outcome:
    import torch
    from repro_torch.core.calibrate import CalibrationSpec
    from repro_torch.core.desim import simulate_utilization
    from repro_torch.core.orchestrator import OrchestratorConfig
    from repro_torch.core.power import PowerParams
    from repro_torch.core.telemetry import TelemetryWindow
    from repro_torch.core.twin import DigitalTwin
    from repro_torch.traces.schema import DatacenterConfig

    cfg, tr = cell.config, cell.traffic
    phases = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    common.build_kernels(device, tr["kernels"])
    phases["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    dc = DatacenterConfig(**cfg["datacenter"])
    tw = cfg["twin"]["bins_per_window"]
    weeks = [surf22.make_week(cfg["trace"], cfg["datacenter"], seeds.derive(seed, seeds.WEEKS, i))
             for i in range(tr["pool_weeks"])]
    t_bins = weeks[0]["t_bins"]
    n_win = t_bins // tw
    phases["weeks"] = time.perf_counter() - t
    t = time.perf_counter()
    pool, telemetry = [], []
    for i, week in enumerate(weeks):
        wl = common.workload(torch, week, device)
        u = simulate_utilization(wl, num_hosts=dc.num_hosts, cores_per_host=dc.cores_per_host,
                                 t_bins=t_bins).u_th.cpu().numpy()
        real = surf22.ground_truth_power(u, cfg["ground_truth"],
                                         seeds.derive(seed, seeds.TRUTH, i)).astype(np.float32)
        pool.append(wl)
        telemetry.append([TelemetryWindow(window=w, t0_bin=w * tw, u_th=u[w * tw:(w + 1) * tw],
                                          power_w=real[w * tw:(w + 1) * tw])
                          for w in range(n_win)])
    phases["telemetry"] = time.perf_counter() - t
    ocfg = OrchestratorConfig(bins_per_window=tw,
                              calibration=CalibrationSpec(**cfg["calibration"]),
                              calibrate=cfg["twin"]["calibrate"],
                              history_windows=cfg["twin"]["history_windows"],
                              power_model=cfg["power_model"], device=str(device))
    base = PowerParams(**cfg["base_params"])

    def request(n):
        k = n % len(pool)
        with torch.profiler.record_function("replay.week"):
            twin = DigitalTwin(pool[k], dc, t_bins, ocfg, base)
            return twin, twin.run(lambda w, bins: telemetry[k][w])

    t = time.perf_counter()
    for n in range(tr["warmup_weeks"]):   # warm-up replays, discarded
        request(n)
    common.sync(torch, device)
    phases["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    kept = grid.Reservoir(tr["check"]["requests"], seeds.rng(seed, seeds.SAMPLE))

    def keep(n, out):
        kept.offer((n, *out))

    sink = []
    with trace.traced(torch, traced, sink):
        count, elapsed, walls = common.closed_loop(seconds, request, keep)
    peak = dev_mod.memory_peak(torch, device)
    items = [(n, served(twin, result)) for n, twin, result in sorted(kept.items,
                                                                       key=lambda x: x[0])]
    del kept, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = check(items, weeks, n_win, cfg, tr, seed)
    check_s = time.perf_counter() - t_check
    windows = count * n_win
    metrics = {"e2_windows_per_s": windows / elapsed,
               "e2_week_p95_ms": float(np.percentile(walls, 95)) * 1e3,
               "setup_s": setup_s}
    cal = cfg["calibration"]
    c = cal["r_points"] * (cal["scale_points"] ** 2 if cal["mode"] == "joint" else 1)
    launches = {"calib_mape": [dict(lanes=1, candidates=c, distinct_r=cal["r_points"],
                                    bins=cfg["twin"]["history_windows"] * tw,
                                    hosts=dc.num_hosts)] * windows}
    return common.Outcome(metrics=metrics, attempted=count, failed=0, checks=checks,
                          memory_peak_bytes=peak, trace=sink[0] if sink else None,
                          run={"units": windows, "launches": launches, "unit_wall_s": walls,
                               "check_s": check_s, "setup_phases": phases})


def served(twin, result) -> dict:
    """A finished replay's outputs on the host: its records, the twin's
    state after the last window and the replay's overall MAPE."""
    import torch
    recs = result.records
    state = twin.orchestrator.state

    def params(ps):
        return torch.stack([torch.stack([p.p_idle, p.p_max, p.r]).reshape(3).float()
                            for p in ps]).cpu().numpy()

    used = params([r.params for r in recs])
    nxt = np.concatenate([used[1:], params([state.params])])
    final = {k: getattr(state, k).cpu().numpy() for k in ("hist_u", "hist_p", *STATE_COUNTS)}
    for k in ("slo_samples", "slo_compliant"):      # the one SLO, NFR1
        final[k] = final[k][0]
    return dict(served=ref.Served(
        params_used=used, params_next=nxt, mape=np.array([r.mape for r in recs]),
        pred={k: torch.stack([getattr(r.prediction, k) for r in recs]).double().cpu().numpy()
              for k in ref.LEAVES},
        state=final), overall_mape=float(result.overall_mape), windows=len(recs))


def check(items: list, weeks: list, n_win: int, cfg: dict, tr: dict, seed: int,
          dtype=None) -> report.Checks:
    """Hold each sampled replay against the reference, window by window.
    ``items`` are ``(request, served(...))``; with ``dtype`` (the control)
    the reference computed in that precision takes the served replay's
    place, and each item's ``served`` is ignored."""
    import torch
    limits = tr["check"]["limits"]
    grid_c = ref.candidate_grid(cfg["calibration"], cfg["base_params"])
    tw, hist = cfg["twin"]["bins_per_window"], cfg["twin"]["history_windows"]
    dc = cfg["datacenter"]
    peak = dc["num_hosts"] * dc["cores_per_host"] * dc["ghz"] * 1e9 * dc["flops_per_cycle"] / 1e12
    kw = dict(base=cfg["base_params"], history=hist, slo_threshold=cfg["slo"]["threshold"],
              peak=peak)
    windows = list(range(n_win))
    worst = {}
    short = 0
    for n, item in items:
        k = n % len(weeks)
        u = ref.week_field(weeks[k], dc)
        real = surf22.ground_truth_power(u, cfg["ground_truth"],
                                         seeds.derive(seed, seeds.TRUTH, k)).astype(np.float32)
        want = ref.Week(u, real, tw, grid_c, torch.float64, "cpu")
        if dtype is None:
            if item["windows"] != n_win:
                short += 1
                continue
            got, overall = item["served"], item["overall_mape"]
        else:
            got = ref.follow(ref.Week(u.astype(np.float32), real, tw, grid_c, dtype, "cpu"),
                             windows, **kw)
            overall = want.overall_mape(windows, got.pred["power_w"])
        gaps = ref.compare(got, want, windows, tie=limits["prediction_rel_gap"], **kw)
        used = want.predict(np.asarray(windows), got.params_used, peak)["power_w"]
        gaps["overall_mape_rel_gap"] = ref.rel_gap(
            overall, want.overall_mape(windows, used.cpu().numpy()))
        for name, v in gaps.items():
            worst[name] = max(worst.get(name, 0.0), v)
    checks = report.Checks()
    for name, v in worst.items():
        checks.add(name, v, limits[name])
    checks.add("replays_short", short + max(0, tr["check"]["requests"] - len(items)), 0)
    return checks
