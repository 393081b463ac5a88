"""From a lane's schedule to its utilization field and per-bin prediction.

The field: each started job adds its phase's per-core utilization times its
cores to its host in every bin it runs, summed in float64 and divided by the
host's cores.  The prediction is the OpenDC power model
``P(u) = P_idle + (P_max - P_idle) (2u - u^r)`` (arXiv:2604.11445 §3.2)
summed over the online hosts, capped, with the capped bins' utilization
throttled by the share of the above-idle draw the cap leaves.  ``dtype``
sets the precision of the prediction (float64 for the reference; a lower
one makes the control).
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_SECONDS = 300.0


def end_bins(job_start, dur, job_host, fail) -> np.ndarray:
    """Each started job's end bin: ``start + max(dur, 1)``, or its host's
    outage start where it is killed by it."""
    st = np.asarray(job_start, np.int64)
    end = st + np.maximum(np.asarray(dur, np.int64), 1)
    if fail is not None:
        fs, _, fk = (np.asarray(x) for x in fail)
        hh = np.where(st >= 0, job_host, 0)
        fsj = fs.astype(np.int64)[hh]
        killed = fk.astype(bool)[hh] & (st >= 0) & (st < fsj) & (end > fsj)
        end = np.where(killed, fsj, end)
    return end


def field(job_start, job_host, dur, cores, util, *, num_hosts: int,
          cores_per_host: int, t_bins: int, fail=None) -> np.ndarray:
    """``[T, H]`` float64 utilization of the schedule."""
    st = np.asarray(job_start, np.int64)
    started = st >= 0
    end = np.minimum(end_bins(st, dur, job_host, fail), t_bins)
    jobs = np.nonzero(started & (end > st))[0]
    lengths = end[jobs] - st[jobs]
    rep = np.repeat(jobs, lengths)
    offset = np.arange(rep.size) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    t = st[rep] + offset
    u_phases = util.shape[1]
    dur1 = np.maximum(np.asarray(dur, np.int64), 1)
    phase = np.clip(((t - st[rep]) * u_phases) // dur1[rep], 0, u_phases - 1)
    val = (np.asarray(util, np.float64)[rep, phase]
           * np.asarray(cores, np.float64)[rep])
    host = np.asarray(job_host, np.int64)[rep]
    u = np.bincount(t * num_hosts + host, weights=val,
                    minlength=t_bins * num_hosts).reshape(t_bins, num_hosts)
    return u / max(int(cores_per_host), 1)


def queue_and_running(job_start, job_host, submit, dur, valid, *, t_bins: int,
                      fail=None) -> tuple[np.ndarray, np.ndarray]:
    """Jobs waiting (submitted, valid, not started) and jobs running, ``[T]``."""
    st = np.asarray(job_start, np.int64)
    valid = np.asarray(valid, bool)
    sub = np.asarray(submit, np.int64)
    submitted = np.cumsum(np.bincount(np.clip(sub[valid], 0, t_bins), minlength=t_bins + 1))
    started = np.cumsum(np.bincount(st[st >= 0], minlength=t_bins + 1))
    end = np.minimum(end_bins(st, dur, job_host, fail), t_bins)
    ok = (st >= 0) & (end > st)
    delta = (np.bincount(st[ok], minlength=t_bins + 1)
             - np.bincount(end[ok], minlength=t_bins + 1))
    return (submitted - started)[:t_bins], np.cumsum(delta)[:t_bins]


def predict(u: torch.Tensor, *, p_idle, p_max, r, online: torch.Tensor,
            cap: float, peak_tflops: float, dtype=torch.float64) -> dict:
    """Per-bin leaves of a ``[..., T, H]`` field on ``[..., T, H]`` online
    hosts (0/1); ``p_idle/p_max/r`` broadcast against ``[..., 1, H]`` or are
    numbers; ``cap`` in W (``inf``: uncapped)."""
    u = u.to(dtype)
    on = online.to(dtype)
    pi, pm, rr = (torch.as_tensor(x, dtype=dtype, device=u.device) for x in (p_idle, p_max, r))
    uc = u.clamp(0.0, 1.0)
    host_p = pi + (pm - pi) * (2.0 * uc - torch.pow(uc, rr))
    demand = (host_p * on).sum(dim=-1)
    floor = (pi * on).sum(dim=-1) if pi.dim() else pi * on.sum(dim=-1)
    util_raw = (u * on).sum(dim=-1) / on.sum(dim=-1).clamp(min=1.0)
    capt = torch.full_like(demand, float(cap))
    exceeded = demand > capt
    power = torch.minimum(demand, capt)
    throttle = ((capt - floor) / (demand - floor).clamp(min=1e-9)).clamp(0.0, 1.0)
    energy = power * (SAMPLE_SECONDS / 3600.0) / 1000.0
    util = torch.where(exceeded, util_raw * throttle, util_raw)
    tflops = util * peak_tflops
    return {"power_w": power, "energy_kwh": energy, "tflops": tflops,
            "utilization": util, "efficiency": tflops / energy.clamp(min=1e-9),
            "power_demand_w": demand}


def peak_tflops(num_hosts: int, dc: dict) -> float:
    return (num_hosts * dc["cores_per_host"] * dc["ghz"] * 1e9
            * dc["flops_per_cycle"]) / 1e12
