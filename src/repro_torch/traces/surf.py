"""Synthetic SURF-22 workload + ground-truth telemetry synthesis.

Port of ``repro.traces.surf``.  Generation stays in numpy with the same
``numpy.random.default_rng(seed)`` call sequence as the JAX package, so a
seed gives the identical workload in both; tensors are made at the
boundary, on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.traces.schema import SAMPLE_SECONDS, DatacenterConfig, Workload

#: bins per day at the 5-minute sampling granularity
BINS_PER_DAY = int(24 * 3600 / SAMPLE_SECONDS)  # 288


@dataclasses.dataclass(frozen=True)
class SurfTraceSpec:
    """Knobs of the synthetic SURF-22 surrogate."""

    days: float = 7.0
    mean_cpu_hours: float = 39.52      # SURF-22 mean job CPU-hours
    duration_sigma: float = 1.1        # lognormal sigma of durations
    target_utilization: float = 0.28   # paper §3.3: "under 30 % ... used"
    seed: int = 22


def _num_bins(spec: SurfTraceSpec) -> int:
    return int(round(spec.days * BINS_PER_DAY))


def make_surf22_like(
    spec: SurfTraceSpec = SurfTraceSpec(),
    dc: DatacenterConfig = DatacenterConfig(),
    num_phases: int = 8,
    device: "str | torch.device" = "cuda",
) -> Workload:
    """Generate the synthetic SURF-22-like workload on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    t_bins = _num_bins(spec)

    total_core_bins = dc.num_hosts * dc.cores_per_host * t_bins * spec.target_utilization
    mean_bins = spec.mean_cpu_hours * 3600.0 / SAMPLE_SECONDS
    jobs: list[tuple[int, int, int]] = []
    mass = 0.0
    mu = np.log(mean_bins) - spec.duration_sigma**2 / 2.0
    while mass < total_core_bins:
        core_bins = float(rng.lognormal(mu, spec.duration_sigma))
        cores = int(min(dc.cores_per_host, max(1, rng.geometric(0.35))))
        dur = int(np.clip(round(core_bins / cores), 1, t_bins))
        day = rng.integers(0, max(1, int(spec.days)))
        hour_weights = 0.5 + 0.5 * np.sin(np.linspace(0, 2 * np.pi, 24, endpoint=False) - np.pi / 2) ** 2
        hour = rng.choice(24, p=hour_weights / hour_weights.sum())
        minute_bin = rng.integers(0, BINS_PER_DAY // 24)
        submit = int(day * BINS_PER_DAY + hour * (BINS_PER_DAY // 24) + minute_bin)
        submit = min(submit, t_bins - 1)
        jobs.append((submit, dur, cores))
        mass += dur * cores

    j = len(jobs)
    submit = np.array([x[0] for x in jobs], np.int32)
    dur = np.array([x[1] for x in jobs], np.int32)
    cores = np.array([x[2] for x in jobs], np.int32)

    base = rng.beta(2.2, 1.3, size=(j, 1)).astype(np.float32)
    wobble = rng.normal(0, 0.08, size=(j, num_phases)).astype(np.float32)
    ramp = np.linspace(0.6, 1.0, num_phases, dtype=np.float32)[None, :]
    util = np.clip(base * ramp + wobble, 0.05, 1.0)

    # sort by submission: the simulator places in submit order (FCFS)
    order = np.argsort(submit, kind="stable")
    return Workload(
        submit_bin=torch.from_numpy(submit[order]).to(dev),
        duration_bins=torch.from_numpy(dur[order]).to(dev),
        cores=torch.from_numpy(cores[order]).to(dev),
        util_levels=torch.from_numpy(np.ascontiguousarray(util[order])).to(dev),
        valid=torch.ones((j,), dtype=torch.bool, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class GroundTruthSpec:
    """Hidden-model parameters for telemetry synthesis (unknown to the sim)."""

    p_idle_mean: float = 71.5
    p_idle_spread: float = 6.0
    p_max_mean: float = 362.0
    p_max_spread: float = 18.0
    r_start: float = 1.45
    r_end: float = 3.40
    r_diurnal: float = 0.10
    wander_daily_sigma: float = 0.02
    noise_active_frac: float = 0.10
    noise_total_frac: float = 0.006
    step_day: float | None = 4.5
    step_frac: float = 0.05
    seed: int = 7


def synthesize_ground_truth(
    u_th: "np.ndarray | torch.Tensor",
    gt: GroundTruthSpec = GroundTruthSpec(),
) -> np.ndarray:
    """Produce 'measured reality' power telemetry ``[T]`` (float64 numpy).

    The hidden model is the OpenDC form with per-host parameters, a
    time-varying exponent r*(t), facility wander and heteroscedastic meter
    noise.  The per-host power map is evaluated in float32, as the JAX
    package does, and summed over hosts in float64.
    """
    if isinstance(u_th, torch.Tensor):
        u_th = u_th.detach().cpu().numpy()
    u = np.asarray(u_th, np.float64)
    t_bins, num_hosts = u.shape
    rng = np.random.default_rng(gt.seed)

    p_idle_h = rng.normal(gt.p_idle_mean, gt.p_idle_spread, num_hosts)
    p_max_h = rng.normal(gt.p_max_mean, gt.p_max_spread, num_hosts)
    tt = np.linspace(0.0, 1.0, t_bins)
    days = max(t_bins / BINS_PER_DAY, 1.0)
    r_t = (
        gt.r_start
        + (gt.r_end - gt.r_start) * tt
        + gt.r_diurnal * np.sin(2 * np.pi * tt * days)
    )

    u32 = np.clip(u.astype(np.float32), 0.0, 1.0)
    pi32 = p_idle_h.astype(np.float32)[None, :]
    pm32 = p_max_h.astype(np.float32)[None, :]
    shape = np.float32(2.0) * u32 - np.power(u32, r_t.astype(np.float32)[:, None])
    p_th = (pi32 + (pm32 - pi32) * shape).astype(np.float64)
    total = p_th.sum(axis=1)
    idle_floor = float(p_idle_h.sum())
    active = np.maximum(total - idle_floor, 0.0)

    step_sigma = gt.wander_daily_sigma / np.sqrt(BINS_PER_DAY)
    wander = np.exp(np.cumsum(rng.normal(0.0, step_sigma, t_bins)))

    step = np.ones(t_bins)
    if gt.step_day is not None:
        step_bin = int(gt.step_day * BINS_PER_DAY)
        if 0 <= step_bin < t_bins:
            step[step_bin:] += gt.step_frac

    noise = (
        rng.normal(0.0, 1.0, t_bins) * (gt.noise_active_frac * active)
        + rng.normal(0.0, 1.0, t_bins) * (gt.noise_total_frac * total)
    )
    return (total * wander * step + noise).astype(np.float64)
