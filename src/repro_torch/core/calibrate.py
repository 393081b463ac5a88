"""Self-Calibrator (paper §2.4, component G), port of ``repro.core.calibrate``.

Utilization is independent of the power-model parameters, so instead of
re-running the simulation per candidate the calibrator re-evaluates the
power map over a cached utilization window for all candidates at once,
through the ``calib_mape_grid`` kernel (:mod:`repro_torch.kernels.ops`).

Faithful mode (the paper): a 1-D grid over the exponent ``r``.
Beyond-paper mode: a 3-D grid over ``(r, p_idle, p_max)``, iterative zoom
refinement, and a per-host refit.  :func:`calibrate_traced` is the
twin core's cycle (no host round trip); :func:`calibrate_window` and
:class:`SelfCalibrator` are the host-side cycle and the pipelined
calibrator.
"""

from __future__ import annotations

import dataclasses
import functools
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
    """MAPE [%] of every candidate over the window, ``[C]`` (or ``[B, C]``
    for a ``[B, T, H]`` window; candidates ``[C]`` shared by every row, or
    ``[L, C]`` rows, each shared by ``B / L`` consecutive rows)."""
    return ops.calib_mape_grid(u_th, real_power, cand.p_idle, cand.p_max,
                               cand.r)


@functools.lru_cache(maxsize=None)
def _weights(n: int, device: torch.device) -> Tensor:
    """``[1 - s, s]`` with ``s = i / (n - 1)``, ``[2, n]`` float32, formed on
    the host by true division and copied to ``device`` once per ``(n,
    device)``: a division by a number on the card multiplies by its
    reciprocal, one ulp off at some ``i``, so a grid formed there would
    differ from the CPU's.  Callers only read the cached tensor."""
    s = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    return torch.from_numpy(np.stack([np.float32(1.0) - s, s])).to(device)


def _linspace(lo, hi, n: int, like: Tensor) -> Tensor:
    """``jnp.linspace`` in float32 on tensor bounds: ``lo*(1-s) + hi*s``.

    Refine rounds only; it may differ from ``jnp.linspace`` in the last
    ulp, so refined parameters agree with the JAX package to a tolerance.
    The card and the CPU form the same values (:func:`_weights`).
    """
    lo = torch.as_tensor(lo, dtype=torch.float32, device=like.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=like.device)
    if n == 1:
        return lo.reshape(1)
    w = _weights(n, like.device)
    out = lo * w[0] + hi * w[1]
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


# -- the fleet's calibration: D lanes' cycles in one launch a round ------------

def _linspace_rows(lo: Tensor, hi: Tensor, n: int) -> Tensor:
    """:func:`_linspace` row by row: ``[D]`` bounds give ``[D, n]``, each row
    the values :func:`_linspace` gives for that row's bounds."""
    if n == 1:
        return lo[:, None].clone()
    w = _weights(n, lo.device)
    out = lo[:, None] * w[0] + hi[:, None] * w[1]
    out[:, -1] = hi
    return out


def _grid_traced_lanes(spec: CalibrationSpec, best: PowerParams,
                       r_lo: Tensor, r_hi: Tensor, s_lo, s_hi) -> PowerParams:
    """:func:`_grid_traced` for D lanes at once: ``best`` holds ``[D]``
    incumbents and ``r_lo/r_hi`` ``[D]`` bounds; the scale bounds are the
    same for every lane.  Gives ``[D, C]`` candidate rows, each row the
    grid :func:`_grid_traced` builds for that lane."""
    r = _linspace_rows(r_lo, r_hi, spec.r_points)                 # [D, R]
    pi_base, pm_base = best.p_idle, best.p_max                    # [D]
    d = r.shape[0]
    if spec.mode == "r_only":
        c = spec.r_points
        return PowerParams(p_idle=pi_base[:, None].expand(d, c).contiguous(),
                           p_max=pm_base[:, None].expand(d, c).contiguous(), r=r)
    s = _linspace(s_lo, s_hi, spec.scale_points, r)               # [S]
    n = spec.scale_points
    rr = r[:, :, None, None].expand(d, spec.r_points, n, n)
    p_idle = (s[None, None, :, None] * pi_base[:, None, None, None]).expand_as(rr)
    p_max = (s[None, None, None, :] * pm_base[:, None, None, None]).expand_as(rr)
    p_idle, p_max = p_idle.reshape(d, -1), p_max.reshape(d, -1)
    return PowerParams(p_idle=p_idle, p_max=torch.maximum(p_max, p_idle),
                       r=rr.reshape(d, -1))


def _pick_rows(cand: PowerParams, b: Tensor) -> PowerParams:
    """Candidate ``b[d]`` of each lane's row: ``[D, C]`` leaves, ``[D]``
    (or ``[D, K]``) indices."""
    idx = b if b.dim() == 2 else b[:, None]

    def take(x):
        got = x.gather(1, idx)
        return got if b.dim() == 2 else got[:, 0]

    return PowerParams(p_idle=take(cand.p_idle), p_max=take(cand.p_max),
                       r=take(cand.r))


def calibrate_traced_lanes(
    u_th: Tensor,
    real_power: Tensor,
    cand: PowerParams,
    spec: CalibrationSpec,
    base: PowerParams,
) -> tuple[PowerParams, Tensor]:
    """:func:`calibrate_traced` for a fleet of D twins, lanes written out.

    ``u_th`` ``[D, T, H]``, ``real_power`` ``[D, T]``, each lane's
    candidate grid ``cand`` as ``[D, C]`` rows and its base parameters
    ``base`` (``[D]``, or ``[D, H]`` rows with ``spec.per_host``).  Every
    round scores all D lanes' candidates in one ``calib_mape_grid`` launch
    (per-lane rows; each lane's refine round builds its own grid around
    its incumbent), and the per-host refit scores the D x H host problems
    in one more.  Each lane is the computation :func:`calibrate_traced`
    does for it alone; the kernel tiles a lane as it tiles that call, so
    on the card the two agree bit for bit.
    """
    mapes = evaluate_candidates(u_th, real_power, cand)          # [D, C]
    b = _argmin_nan_last(mapes)
    best = _pick_rows(cand, b)
    best_mape = mapes.gather(1, b[:, None])[:, 0]
    any_finite = torch.isfinite(mapes).any(dim=-1)

    r_lo, r_hi = spec.r_lo, spec.r_hi
    s_lo, s_hi = spec.scale_lo, spec.scale_hi
    for _ in range(spec.refine_iters):
        span_r = (r_hi - r_lo) * spec.refine_shrink
        span_s = (s_hi - s_lo) * spec.refine_shrink
        r_lo = torch.clamp(best.r - span_r / 2, min=1.0)
        r_hi = best.r + span_r / 2
        s_lo, s_hi = 1.0 - span_s / 2, 1.0 + span_s / 2
        cand2 = _grid_traced_lanes(spec, best, r_lo, r_hi, s_lo, s_hi)
        m2 = evaluate_candidates(u_th, real_power, cand2)
        b2 = _argmin_nan_last(m2)
        m2b = m2.gather(1, b2[:, None])[:, 0]
        better = torch.isfinite(m2b) & (torch.isnan(best_mape) | (m2b < best_mape))
        won = _pick_rows(cand2, b2)
        best = PowerParams(
            p_idle=torch.where(better, won.p_idle, best.p_idle),
            p_max=torch.where(better, won.p_max, best.p_max),
            r=torch.where(better, won.r, best.r))
        best_mape = torch.where(better, m2b, best_mape)
        any_finite = any_finite | torch.isfinite(m2).any(dim=-1)

    def keep(chosen, fallback):
        fb = fallback.float()
        fb = fb.mean(dim=-1) if fb.dim() == 2 else fb
        return torch.where(any_finite, chosen, fb)

    params = PowerParams(p_idle=keep(best.p_idle, base.p_idle),
                         p_max=keep(best.p_max, base.p_max),
                         r=keep(best.r, base.r))
    if spec.per_host:
        return _per_host_refit_lanes(u_th, real_power, cand, params, best_mape)
    return params, best_mape


def _per_host_refit_lanes(
    u_th: Tensor,
    real_power: Tensor,
    cand: PowerParams,
    fleet_params: PowerParams,
    fleet_mape: Tensor,
) -> tuple[PowerParams, Tensor]:
    """:func:`_per_host_refit` for D lanes: the D x H problems of ``[T, 1]``
    go to the kernel as one launch, each host scored over its lane's
    candidate row.  Gives ``[D, H]`` rows and ``[D]`` MAPEs."""
    d, t, h = u_th.shape
    lane = PowerParams(*(x[:, None, None] for x in (fleet_params.p_idle,
                                                    fleet_params.p_max,
                                                    fleet_params.r)))
    pred = opendc_power(u_th, lane)                             # [D, T, H]
    total = pred.sum(dim=-1, keepdim=True)
    share = pred / total.clamp(min=1e-9)
    target = real_power[..., None] * share                      # [D, T, H]
    m = evaluate_candidates(
        u_th.transpose(1, 2).contiguous().reshape(d * h, t, 1),
        target.transpose(1, 2).contiguous().reshape(d * h, t),
        cand).reshape(d, h, -1)                                 # [D, H, C]
    b = _argmin_nan_last(m)                                     # [D, H]
    host_finite = torch.isfinite(m).any(dim=-1)
    host = _pick_rows(cand, b)

    def row(hp, fp):
        return torch.where(host_finite, hp.float(), fp[:, None])

    rows = PowerParams(p_idle=row(host.p_idle, fleet_params.p_idle),
                       p_max=row(host.p_max, fleet_params.p_max),
                       r=row(host.r, fleet_params.r))
    combined = opendc_power(u_th, PowerParams(
        *(x[:, None, :] for x in (rows.p_idle, rows.p_max, rows.r)))).sum(dim=-1)
    per_host_mape = mape(real_power, combined, dim=-1)
    best_mape = torch.where(torch.isnan(per_host_mape), fleet_mape,
                            per_host_mape)
    return rows, best_mape


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    params: PowerParams          # scalar best parameters
    mape: float                  # best candidate's window MAPE [%]
    evaluated: int               # number of candidates evaluated
    mapes: np.ndarray            # [C] all candidate MAPEs (diagnostics)


def calibrate_window(
    u_th: Tensor,
    real_power: Tensor,
    spec: CalibrationSpec,
    base: PowerParams,
) -> CalibrationResult:
    """One calibration cycle (one C-event in Fig. 3), host-side.

    Runs on ``u_th``'s device: the grid is built there and scored by the
    ``calib_mape_grid`` kernel, and the MAPEs come back to the host, where
    the argmin and the refine rounds' bounds are taken.  An all-zero-power
    window has no defined MAPE: every candidate scores NaN and ``base`` is
    kept.
    """
    if not isinstance(u_th, Tensor):
        raise TypeError("calibrate_window: u_th must be a torch.Tensor (the "
                        f"cycle runs on its device), got {type(u_th)!r}")
    dev = u_th.device
    real_power = torch.as_tensor(real_power, dtype=torch.float32, device=dev)
    cand = candidate_grid(spec, base, device=dev)
    mapes_np = evaluate_candidates(u_th, real_power, cand).cpu().numpy()
    total = int(mapes_np.shape[0])
    if not np.isfinite(mapes_np).any():
        return CalibrationResult(base, float("nan"), total, mapes_np)

    def point(c: PowerParams, i: int) -> PowerParams:
        return PowerParams(p_idle=float(c.p_idle[i]), p_max=float(c.p_max[i]),
                           r=float(c.r[i]))

    best = int(np.argmin(mapes_np))
    best_params = point(cand, best)
    best_mape = float(mapes_np[best])

    # beyond-paper: iterative zoom refinement around the incumbent
    cur = spec
    for _ in range(spec.refine_iters):
        span_r = (cur.r_hi - cur.r_lo) * spec.refine_shrink
        span_s = (cur.scale_hi - cur.scale_lo) * spec.refine_shrink
        cur = dataclasses.replace(
            cur,
            r_lo=max(1.0, best_params.r - span_r / 2),
            r_hi=best_params.r + span_r / 2,
            scale_lo=1.0 - span_s / 2,
            scale_hi=1.0 + span_s / 2,
        )
        cand = candidate_grid(cur, best_params, device=dev)
        m = evaluate_candidates(u_th, real_power, cand).cpu().numpy()
        total += int(m.shape[0])
        b = int(np.argmin(m))
        if float(m[b]) < best_mape:
            best_mape = float(m[b])
            best_params = point(cand, b)
    return CalibrationResult(best_params, best_mape, total, mapes_np)


class SelfCalibrator:
    """Pipelined calibrator: results from window k feed simulation of k+1.

    The paper's two-thread timeline (Fig. 3), deterministically: call
    :meth:`observe` when window-k telemetry lands and
    :meth:`params_for_next` when the engine starts window k+1.  The last
    ``history_windows`` windows are kept on the host and calibrated on
    ``device`` (``"cuda"`` needs a card).
    """

    def __init__(self, spec: CalibrationSpec, base: PowerParams,
                 device: "str | torch.device" = "cuda",
                 history_windows: int = 4):
        self.spec = spec
        self.base = base
        self.device = resolve_device(device)
        self.history_windows = history_windows
        self._pending = base       # result of the latest completed cycle
        self._u: list[np.ndarray] = []
        self._p: list[np.ndarray] = []
        self.history: list[CalibrationResult] = []

    def observe(self, u_th, real_power) -> CalibrationResult:
        """Ingest window telemetry, run one calibration cycle."""
        def host(x):
            return (x.detach().cpu().numpy() if isinstance(x, Tensor)
                    else np.asarray(x))

        self._u.append(host(u_th))
        self._p.append(host(real_power))
        self._u = self._u[-self.history_windows:]
        self._p = self._p[-self.history_windows:]
        u = torch.as_tensor(np.concatenate(self._u, axis=0), dtype=torch.float32,
                            device=self.device)
        p = torch.as_tensor(np.concatenate(self._p, axis=0), dtype=torch.float32,
                            device=self.device)
        res = calibrate_window(u, p, self.spec, self.base)
        self.history.append(res)
        self._pending = res.params
        return res

    def params_for_next(self) -> PowerParams:
        """Parameters the simulation engine should use for the next window."""
        return self._pending
