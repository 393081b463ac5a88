"""Self-Calibrator (paper §2.4, component G), port of ``repro.core.calibrate``.

Utilization is independent of the power-model parameters, so instead of
re-running the simulation per candidate the calibrator re-evaluates the
power map over a cached utilization window for all candidates at once,
through the ``calib_mape_grid`` kernel (:mod:`repro_torch.kernels.ops`).

Faithful mode (the paper): a 1-D grid over the exponent ``r``.
Beyond-paper mode: a 3-D grid over ``(r, p_idle, p_max)``, iterative zoom
refinement, and a per-host refit.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.power import PowerParams, mape, opendc_power
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CalibrationSpec:
    """Grid-search configuration (see ``repro.core.calibrate``)."""

    mode: Literal["r_only", "joint"] = "r_only"
    r_lo: float = 1.0
    r_hi: float = 6.0
    r_points: int = 64
    scale_lo: float = 0.85
    scale_hi: float = 1.15
    scale_points: int = 12
    refine_iters: int = 0          # 0 = pure grid (faithful); >0 = zoom refine
    refine_shrink: float = 0.25
    per_host: bool = False


def _mean(x) -> float:
    if isinstance(x, Tensor):
        return float(x.detach().float().mean())
    return float(np.asarray(x).mean())


def candidate_grid(spec: CalibrationSpec, base: PowerParams,
                   device: "str | torch.device" = "cuda") -> PowerParams:
    """The candidate grid as a batched ``PowerParams`` of ``[C]`` tensors on
    ``device`` (``"cuda"`` needs a card).

    Built host-side with ``np.linspace`` in float32, so the values are bit
    for bit those of the JAX package.  Joint mode clamps each candidate's
    ``p_max`` to its ``p_idle`` (narrow-span bases stay valid).
    """
    device = resolve_device(device)
    r = np.linspace(spec.r_lo, spec.r_hi, spec.r_points, dtype=np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    if spec.mode == "r_only":
        c = r.shape[0]
        return PowerParams(
            p_idle=t(np.full((c,), _mean(base.p_idle), np.float32)),
            p_max=t(np.full((c,), _mean(base.p_max), np.float32)),
            r=t(r))
    s = np.linspace(spec.scale_lo, spec.scale_hi, spec.scale_points, dtype=np.float32)
    rr, si, sm = np.meshgrid(r, s, s, indexing="ij")
    p_idle = si.ravel() * np.float32(_mean(base.p_idle))
    p_max = sm.ravel() * np.float32(_mean(base.p_max))
    return PowerParams(p_idle=t(p_idle), p_max=t(np.maximum(p_max, p_idle)),
                       r=t(rr.ravel()))


def evaluate_candidates(u_th: Tensor, real_power: Tensor,
                        cand: PowerParams) -> Tensor:
    """MAPE [%] of every candidate over the window, ``[C]`` (or ``[B, C]``)."""
    return ops.calib_mape_grid(u_th, real_power, cand.p_idle, cand.p_max,
                               cand.r)


def _linspace(lo, hi, n: int, like: Tensor) -> Tensor:
    """``jnp.linspace`` in float32 on tensor bounds: ``lo*(1-s) + hi*s``.

    Refine rounds only; it may differ from ``jnp.linspace`` in the last
    ulp, so refined parameters agree with the JAX package to a tolerance.
    """
    lo = torch.as_tensor(lo, dtype=torch.float32, device=like.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=like.device)
    if n == 1:
        return lo.reshape(1)
    step = torch.arange(n, dtype=torch.float32, device=like.device) / (n - 1)
    out = lo * (1.0 - step) + hi * step
    out[-1] = hi
    return out


def _grid_traced(spec: CalibrationSpec, base: PowerParams,
                 r_lo, r_hi, s_lo, s_hi) -> PowerParams:
    """Candidate grid with tensor bounds (the refine path), on ``base``'s device."""
    like = base.r
    r = _linspace(r_lo, r_hi, spec.r_points, like)
    pi_base = torch.as_tensor(base.p_idle, dtype=torch.float32).mean()
    pm_base = torch.as_tensor(base.p_max, dtype=torch.float32).mean()
    if spec.mode == "r_only":
        c = spec.r_points
        return PowerParams(p_idle=pi_base.expand(c).contiguous(),
                           p_max=pm_base.expand(c).contiguous(), r=r)
    s = _linspace(s_lo, s_hi, spec.scale_points, like)
    rr, si, sm = torch.meshgrid(r, s, s, indexing="ij")
    p_idle = si.reshape(-1) * pi_base
    p_max = sm.reshape(-1) * pm_base
    return PowerParams(p_idle=p_idle, p_max=torch.maximum(p_max, p_idle),
                       r=rr.reshape(-1))


def _argmin_nan_last(m: Tensor) -> Tensor:
    """First index of the smallest value, NaN counted as +inf."""
    return torch.where(torch.isnan(m), torch.full_like(m, float("inf")),
                       m).argmin(dim=-1)


def _pick(cand: PowerParams, b: Tensor) -> PowerParams:
    return PowerParams(p_idle=cand.p_idle[b], p_max=cand.p_max[b], r=cand.r[b])


def calibrate_traced(
    u_th: Tensor,
    real_power: Tensor,
    cand: PowerParams,
    spec: CalibrationSpec,
    base: PowerParams,
) -> tuple[PowerParams, Tensor]:
    """One calibration cycle without host round trips.

    ``cand`` is the precomputed base grid (:func:`candidate_grid`).
    Returns ``(params, best_mape)``: the argmin-MAPE candidate, refined
    ``spec.refine_iters`` times, or ``base`` with a NaN MAPE when no
    candidate has a defined MAPE (all-zero-power history).
    """
    mapes = evaluate_candidates(u_th, real_power, cand)
    b = _argmin_nan_last(mapes)
    best = _pick(cand, b)
    best_mape = mapes[b]
    any_finite = torch.isfinite(mapes).any()

    r_lo, r_hi = spec.r_lo, spec.r_hi
    s_lo, s_hi = spec.scale_lo, spec.scale_hi
    for _ in range(spec.refine_iters):
        span_r = (r_hi - r_lo) * spec.refine_shrink
        span_s = (s_hi - s_lo) * spec.refine_shrink
        r_lo = torch.clamp(best.r - span_r / 2, min=1.0)
        r_hi = best.r + span_r / 2
        s_lo, s_hi = 1.0 - span_s / 2, 1.0 + span_s / 2
        cand2 = _grid_traced(spec, best, r_lo, r_hi, s_lo, s_hi)
        m2 = evaluate_candidates(u_th, real_power, cand2)
        b2 = _argmin_nan_last(m2)
        # NaN-safe both ways: a NaN refined candidate never wins, and a NaN
        # incumbent loses to any finite one
        better = torch.isfinite(m2[b2]) & (torch.isnan(best_mape)
                                           | (m2[b2] < best_mape))
        best = PowerParams(
            p_idle=torch.where(better, cand2.p_idle[b2], best.p_idle),
            p_max=torch.where(better, cand2.p_max[b2], best.p_max),
            r=torch.where(better, cand2.r[b2], best.r))
        best_mape = torch.where(better, m2[b2], best_mape)
        any_finite = any_finite | torch.isfinite(m2).any()

    def keep(chosen, fallback):
        fb = torch.as_tensor(fallback, dtype=torch.float32,
                             device=chosen.device).mean()
        return torch.where(any_finite, chosen, fb)

    params = PowerParams(p_idle=keep(best.p_idle, base.p_idle),
                         p_max=keep(best.p_max, base.p_max),
                         r=keep(best.r, base.r))
    if spec.per_host:
        return _per_host_refit(u_th, real_power, cand, params, best_mape)
    return params, best_mape


def _per_host_refit(
    u_th: Tensor,
    real_power: Tensor,
    cand: PowerParams,
    fleet_params: PowerParams,
    fleet_mape: Tensor,
) -> tuple[PowerParams, Tensor]:
    """Per-host re-fit stage of ``CalibrationSpec(per_host=True)``.

    The measured total is attributed to hosts by each host's predicted
    share under the fleet fit, then every host grid-searches its own row
    over the shared candidate grid: all H problems of ``[T, 1]`` go to the
    kernel as one batched launch.  Hosts with no finite MAPE keep the fleet
    row; the returned MAPE is the total-power MAPE of the combined per-host
    prediction (the fleet MAPE when that is undefined).
    """
    pred = opendc_power(u_th, fleet_params)                    # [T, H]
    total = pred.sum(dim=-1, keepdim=True)
    share = pred / total.clamp(min=1e-9)
    target = real_power[..., None] * share                     # [T, H]
    m = evaluate_candidates(u_th.T.contiguous()[..., None],
                            target.T.contiguous(), cand)       # [H, C]
    b = _argmin_nan_last(m)
    host_finite = torch.isfinite(m).any(dim=1)
    host = _pick(cand, b)

    def row(hp, fp):
        fp = torch.as_tensor(fp, dtype=torch.float32, device=hp.device)
        return torch.where(host_finite, hp.float(), fp)

    rows = PowerParams(p_idle=row(host.p_idle, fleet_params.p_idle),
                       p_max=row(host.p_max, fleet_params.p_max),
                       r=row(host.r, fleet_params.r))
    combined = opendc_power(u_th, rows).sum(dim=-1)            # [T]
    per_host_mape = mape(real_power, combined)
    best_mape = torch.where(torch.isnan(per_host_mape), fleet_mape,
                            per_host_mape)
    return rows, best_mape
