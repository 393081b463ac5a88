"""The SURF-22 surrogate trace and its hidden-model power telemetry.

A copy of the port's generator (``repro_torch.traces.surf.make_surf22_like``
and ``synthesize_ground_truth``, arXiv:2604.11445 §3.2-3.3), in numpy, so the
benchmark makes its own inputs: the same call sequence on
``numpy.random.default_rng(seed)``, so a seed gives the same trace as the
port's generator (a test holds the two together).
"""

from __future__ import annotations

import numpy as np

SAMPLE_SECONDS = 300.0
BINS_PER_DAY = int(24 * 3600 / SAMPLE_SECONDS)  # 288


def make_week(trace: dict, dc: dict, seed: int) -> dict:
    """A job trace of ``trace["days"]`` days, sorted by submission.

    ``trace`` holds ``days``, ``mean_cpu_hours``, ``duration_sigma``,
    ``target_utilization`` and ``num_phases``; ``dc`` ``num_hosts`` and
    ``cores_per_host``.  Returns numpy arrays ``submit``, ``dur``, ``cores``
    (int32 ``[J]``), ``util`` (float32 ``[J, U]``) and ``valid`` (bool).
    """
    days = float(trace["days"])
    rng = np.random.default_rng(seed)
    t_bins = int(round(days * BINS_PER_DAY))
    hosts, cph = int(dc["num_hosts"]), int(dc["cores_per_host"])
    total_core_bins = hosts * cph * t_bins * float(trace["target_utilization"])
    mean_bins = float(trace["mean_cpu_hours"]) * 3600.0 / SAMPLE_SECONDS
    sigma = float(trace["duration_sigma"])
    jobs = []
    mass = 0.0
    mu = np.log(mean_bins) - sigma**2 / 2.0
    while mass < total_core_bins:
        core_bins = float(rng.lognormal(mu, sigma))
        cores = int(min(cph, max(1, rng.geometric(0.35))))
        dur = int(np.clip(round(core_bins / cores), 1, t_bins))
        day = rng.integers(0, max(1, int(days)))
        hour_weights = 0.5 + 0.5 * np.sin(
            np.linspace(0, 2 * np.pi, 24, endpoint=False) - np.pi / 2) ** 2
        hour = rng.choice(24, p=hour_weights / hour_weights.sum())
        minute_bin = rng.integers(0, BINS_PER_DAY // 24)
        submit = int(day * BINS_PER_DAY + hour * (BINS_PER_DAY // 24) + minute_bin)
        jobs.append((min(submit, t_bins - 1), dur, cores))
        mass += dur * cores

    j = len(jobs)
    submit = np.array([x[0] for x in jobs], np.int32)
    dur = np.array([x[1] for x in jobs], np.int32)
    cores = np.array([x[2] for x in jobs], np.int32)
    phases = int(trace["num_phases"])
    base = rng.beta(2.2, 1.3, size=(j, 1)).astype(np.float32)
    wobble = rng.normal(0, 0.08, size=(j, phases)).astype(np.float32)
    ramp = np.linspace(0.6, 1.0, phases, dtype=np.float32)[None, :]
    util = np.clip(base * ramp + wobble, 0.05, 1.0)
    order = np.argsort(submit, kind="stable")
    return dict(submit=submit[order], dur=dur[order], cores=cores[order],
                util=np.ascontiguousarray(util[order]),
                valid=np.ones((j,), bool), t_bins=t_bins)


def ground_truth_power(u_th: np.ndarray, gt: dict, seed: int) -> np.ndarray:
    """'Measured' total power ``[T]`` (float64) of a ``[T, H]`` utilization
    field under the hidden model ``gt`` (per-host parameters, a drifting
    exponent, facility wander, a step and meter noise), drawn from ``seed``."""
    u = np.asarray(u_th, np.float64)
    t_bins, num_hosts = u.shape
    rng = np.random.default_rng(seed)
    p_idle_h = rng.normal(gt["p_idle_mean"], gt["p_idle_spread"], num_hosts)
    p_max_h = rng.normal(gt["p_max_mean"], gt["p_max_spread"], num_hosts)
    tt = np.linspace(0.0, 1.0, t_bins)
    days = max(t_bins / BINS_PER_DAY, 1.0)
    r_t = (gt["r_start"] + (gt["r_end"] - gt["r_start"]) * tt
           + gt["r_diurnal"] * np.sin(2 * np.pi * tt * days))
    u32 = np.clip(u.astype(np.float32), 0.0, 1.0)
    pi32 = p_idle_h.astype(np.float32)[None, :]
    pm32 = p_max_h.astype(np.float32)[None, :]
    shape = np.float32(2.0) * u32 - np.power(u32, r_t.astype(np.float32)[:, None])
    total = (pi32 + (pm32 - pi32) * shape).astype(np.float64).sum(axis=1)
    active = np.maximum(total - float(p_idle_h.sum()), 0.0)
    step_sigma = gt["wander_daily_sigma"] / np.sqrt(BINS_PER_DAY)
    wander = np.exp(np.cumsum(rng.normal(0.0, step_sigma, t_bins)))
    step = np.ones(t_bins)
    if gt.get("step_day") is not None:
        step_bin = int(gt["step_day"] * BINS_PER_DAY)
        if 0 <= step_bin < t_bins:
            step[step_bin:] += gt["step_frac"]
    noise = (rng.normal(0.0, 1.0, t_bins) * (gt["noise_active_frac"] * active)
             + rng.normal(0.0, 1.0, t_bins) * (gt["noise_total_frac"] * total))
    return total * wander * step + noise
