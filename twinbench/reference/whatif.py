"""The what-if sweep worked out again, lane by lane, and the comparison of a
lane's served outputs with it.

A lane is one scenario of the grid over one week: its placement
(:mod:`.placement`), its utilization field, queue and running counts and
per-bin prediction (:mod:`.readout`), and the operator's summary of them.
"""

from __future__ import annotations

import numpy as np
import torch

from twinbench.reference import placement, readout

#: summary fields compared as numbers, and as exact counts
SUMMARY_FLOATS = ("mean_util", "p99_queue", "mean_wait_bins", "p99_wait_bins",
                  "energy_kwh", "mean_power_w", "peak_power_w", "peak_demand_w",
                  "cpu_hours", "kwh_per_cpu_hour")
SUMMARY_COUNTS = ("max_queue", "unplaced_jobs", "total_jobs", "failure_events")
PRED_LEAVES = ("power_w", "energy_kwh", "tflops", "utilization", "efficiency",
               "power_demand_w")


def failure_rows(lane: dict, max_hosts: int):
    fs = np.full(max_hosts, placement.NEVER_BIN, np.int64)
    fe = np.zeros(max_hosts, np.int64)
    fk = np.zeros(max_hosts, bool)
    for w in lane["failures"]:
        for h in range(*w["hosts"]):
            fs[h], fe[h], fk[h] = w["start_bin"], w["end_bin"], w["kind"] == "outage"
    return fs, fe, fk


def schedule(week: dict, lane: dict, *, dc: dict, max_hosts: int, max_backfill: int,
             any_failures: bool, max_starts: int) -> dict:
    """The lane's placement, field and counts (float64)."""
    t_bins = week["t_bins"]
    mask = np.arange(max_hosts) < lane["num_hosts"]
    fail = failure_rows(lane, max_hosts) if any_failures else None
    js, jh, attempts = placement.place_lane(
        week["submit"], week["dur"], week["cores"], week["valid"], mask,
        dc["cores_per_host"], placement.POLICIES[lane["policy"]], lane["backfill_depth"],
        t_bins=t_bins, max_starts=max_starts, max_backfill=max_backfill, fail=fail)
    u = readout.field(js, jh, week["dur"], week["cores"], week["util"],
                      num_hosts=max_hosts, cores_per_host=dc["cores_per_host"],
                      t_bins=t_bins, fail=fail)
    queue, running = readout.queue_and_running(js, jh, week["submit"], week["dur"],
                                               week["valid"], t_bins=t_bins, fail=fail)
    online = np.broadcast_to(mask, u.shape).copy()
    if fail is not None:
        tt = np.arange(t_bins)[:, None]
        online &= ~(fail[2] & (tt >= fail[0]) & (tt < fail[1]))
    return dict(job_start=js, job_host=jh, attempts=attempts, u=u, queue=queue,
                running=running, online=online)


def prediction(sched: dict, lane: dict, *, dc: dict, base: dict,
               dtype=torch.float64) -> dict:
    pred = readout.predict(
        torch.from_numpy(sched["u"]), p_idle=base["p_idle"], p_max=base["p_max"],
        r=base["r"], online=torch.from_numpy(sched["online"]),
        cap=cap_of(lane),
        peak_tflops=readout.peak_tflops(lane["num_hosts"], dc), dtype=dtype)
    return {k: v.double().numpy() for k, v in pred.items()}


def summary(week: dict, lane: dict, job_start, queue, pred: dict) -> dict:
    valid = np.asarray(week["valid"], bool)
    js = np.asarray(job_start, np.int64)
    placed = (js >= 0) & valid
    waits = (js - week["submit"])[placed]
    hours = np.asarray(week["dur"], np.float64) * (300.0 / 3600.0) * week["cores"]
    cpu_h = float(np.where(valid, hours, 0.0).sum())
    e = float(pred["energy_kwh"].sum())
    return dict(
        mean_util=float(pred["utilization"].mean()),
        p99_queue=float(np.percentile(queue, 99)), max_queue=int(queue.max()),
        mean_wait_bins=float(waits.mean()) if waits.size else float("nan"),
        p99_wait_bins=float(np.percentile(waits, 99)) if waits.size else float("nan"),
        unplaced_jobs=int(((js < 0) & valid).sum()), total_jobs=int(valid.sum()),
        energy_kwh=e, mean_power_w=float(pred["power_w"].mean()),
        peak_power_w=float(pred["power_w"].max()),
        peak_demand_w=float(pred["power_demand_w"].max()),
        cpu_hours=cpu_h, kwh_per_cpu_hour=e / cpu_h if cpu_h > 0 else float("nan"),
        failure_events=sum(w["hosts"][1] - w["hosts"][0] for w in lane["failures"]),
        cap_exceeded_bins=int((pred["power_demand_w"] > cap_of(lane)).sum()))


def cap_of(lane: dict) -> float:
    return float("inf") if lane["power_cap_w"] is None else float(lane["power_cap_w"])


def rel_gap(a, b) -> float:
    """Largest ``|a - b| / |b|`` (0 where both are 0, inf where only ``b``
    is); NaN on both sides counts as equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    diff = np.where(both_nan, 0.0, np.abs(a - b))
    den = np.abs(b)
    gap = np.where(den > 0, diff / np.where(den > 0, den, 1.0),
                   np.where(diff > 0, np.inf, 0.0))
    gap = np.where(np.isnan(gap), np.inf, gap)
    return float(gap.max()) if gap.size else 0.0


def compare(got: dict, ref: dict, lane: dict, *, tie: float) -> dict:
    """The numbers the check holds against their limits, for one lane.
    ``got`` holds the served ``job_start``, ``job_host``, prediction leaves
    and summary; ``ref`` the reference's."""
    mism = int(((np.asarray(got["job_start"]) != ref["job_start"])
                | (np.asarray(got["job_host"]) != ref["job_host"])).sum())
    pred_gap = max(rel_gap(got["pred"][k], ref["pred"][k]) for k in PRED_LEAVES)
    s_got, s_ref = got["summary"], ref["summary"]
    sum_gap = max(rel_gap(s_got[k], s_ref[k]) for k in SUMMARY_FLOATS)
    counts = sum(int(s_got[k] != s_ref[k]) for k in SUMMARY_COUNTS)
    cap = lane["power_cap_w"]
    demand = ref["pred"]["power_demand_w"]
    if cap is None:
        lo = hi = 0
    else:
        # a bin whose demand lies within rounding of the cap may fall on
        # either side of it
        lo = int((demand > cap * (1 + tie)).sum())
        hi = int((demand > cap * (1 - tie)).sum())
    counts += int(not lo <= s_got["cap_exceeded_bins"] <= hi)
    return dict(placement_mismatches=mism, prediction_rel_gap=pred_gap,
                summary_rel_gap=sum_gap, summary_count_mismatches=counts)
