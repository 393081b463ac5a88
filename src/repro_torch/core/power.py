"""Power models for datacenter hosts (port of ``repro.core.power``).

The paper (§3.2) adopts the OpenDC analytical CPU power formula

    P(u) = P_idle + (P_max - P_idle) * (2u - u^r)

with ``u`` the CPU utilization in [0, 1] and ``r`` the calibration
parameter tuned by the Self-Calibrator (§2.4).  The linear, sqrt and cubic
models of the OpenDC model zoo share the same idle/max parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def _concrete(x) -> np.ndarray | None:
    """``x`` as a numpy array when it can be read without a device sync.

    Values resident on an accelerator are the twin's own results inside
    the loop (the counterpart of JAX's traced values) and are not pulled
    back to the host just to be validated; every host-side construction
    boundary is checked.
    """
    if isinstance(x, Tensor):
        if x.device.type != "cpu":
            return None
        return x.detach().numpy()
    if isinstance(x, (bool, int, float, np.ndarray, np.generic)):
        return np.asarray(x)
    return None


def validate_power_params(p_idle, p_max, r) -> None:
    """Reject parameterizations outside the model's valid domain, loudly.

    ``r <= 0`` makes ``P(u=0)`` negative (``0^0 = 1``) or infinite,
    non-finite values poison every downstream kWh/gCO2, and
    ``p_max < p_idle`` inverts the power curve.
    """
    rv = _concrete(r)
    if rv is not None and rv.size and (~np.isfinite(rv) | (rv <= 0)).any():
        raise ValueError(
            f"power-model exponent r must be finite and > 0, got "
            f"{float(np.min(rv))}: r <= 0 makes P(u=0) negative "
            "(0^0 = 1 -> shape term -1), r < 0 yields -inf watts, and "
            "NaN/inf poisons every downstream kWh/gCO2")
    pi, pm = _concrete(p_idle), _concrete(p_max)
    if pi is not None and pi.size and (~np.isfinite(pi) | (pi < 0)).any():
        raise ValueError(
            f"p_idle must be finite and >= 0 W, got {float(np.min(pi))}")
    if pm is not None and pm.size and (~np.isfinite(pm)).any():
        raise ValueError("p_max must be finite W, got non-finite value(s)")
    if pi is not None and pm is not None and pi.size and pm.size:
        try:
            bad = np.broadcast_arrays(pm, pi)
        except ValueError:
            return  # non-broadcastable shapes fail later with a shape error
        if (bad[0] < bad[1]).any():
            raise ValueError(
                f"p_max must be >= p_idle (got p_max min "
                f"{float(bad[0].min())} < p_idle {float(bad[1].max())}): a "
                "negative span inverts the power curve")


@dataclasses.dataclass(frozen=True)
class PowerParams:
    """Parameters of the OpenDC analytical power model.

    Each field is a Python scalar, a 0-d tensor (shared across hosts) or a
    ``[H]`` / ``[C]`` tensor (per host, or a batch of candidates).
    """

    p_idle: Tensor | float = 70.0   # W, idle draw per host
    p_max: Tensor | float = 350.0   # W, full-load draw per host
    r: Tensor | float = 2.0         # calibration exponent (paper §3.2)

    def __post_init__(self):
        validate_power_params(self.p_idle, self.p_max, self.r)


def _param(x, u: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=u.dtype, device=u.device)


def opendc_power(u: Tensor, params: PowerParams) -> Tensor:
    """OpenDC analytical model: P(u) = P_idle + (P_max - P_idle)(2u - u^r).

    ``u`` may have any shape; params broadcast against the trailing host
    dim.  Utilization is clipped to [0, 1].
    """
    u = u.clamp(0.0, 1.0)
    p_idle, p_max, r = (_param(x, u) for x in (params.p_idle, params.p_max,
                                               params.r))
    shape = 2.0 * u - torch.pow(u, r)
    return p_idle + (p_max - p_idle) * shape


def linear_power(u: Tensor, params: PowerParams) -> Tensor:
    """FootPrinter-style linear model: the r = 1 special case."""
    u = u.clamp(0.0, 1.0)
    p_idle, p_max = _param(params.p_idle, u), _param(params.p_max, u)
    return p_idle + (p_max - p_idle) * u


def sqrt_power(u: Tensor, params: PowerParams) -> Tensor:
    """Square-root model (OpenDC model zoo)."""
    u = u.clamp(0.0, 1.0)
    p_idle, p_max = _param(params.p_idle, u), _param(params.p_max, u)
    return p_idle + (p_max - p_idle) * torch.sqrt(u)


def cubic_power(u: Tensor, params: PowerParams) -> Tensor:
    """Cubic model (OpenDC model zoo)."""
    u = u.clamp(0.0, 1.0)
    p_idle, p_max = _param(params.p_idle, u), _param(params.p_max, u)
    return p_idle + (p_max - p_idle) * u**3


PowerModelFn = Callable[[Tensor, PowerParams], Tensor]

POWER_MODELS: dict[str, PowerModelFn] = {
    "opendc": opendc_power,
    "linear": linear_power,
    "sqrt": sqrt_power,
    "cubic": cubic_power,
}


def datacenter_power(u_th: Tensor, params: PowerParams,
                     model: str = "opendc",
                     online_mask: Tensor | None = None) -> Tensor:
    """``[T]`` total power draw in watts from ``[T, H]`` utilization."""
    p = POWER_MODELS[model](u_th, params)
    if online_mask is not None:
        p = p * online_mask
    return p.sum(dim=-1)


def energy_kwh(power_w: Tensor, dt_seconds: float) -> Tensor:
    """Integrate a power trace [T] (W) into per-sample energy (kWh)."""
    return power_w * (dt_seconds / 3600.0) / 1000.0


def carbon_gco2(energy_kwh_t: Tensor, intensity) -> Tensor:
    """Per-bin operational carbon [T] gCO2 from energy and grid intensity."""
    return energy_kwh_t * torch.as_tensor(
        intensity, dtype=energy_kwh_t.dtype, device=energy_kwh_t.device)


def mape(real: Tensor, sim: Tensor, eps: float = 1e-9,
         dim: int | None = None) -> Tensor:
    """Mean Absolute Percentage Error, % (paper §3.2).

    Denominator ``|real| + eps``; zero-real bins are excluded from the
    mean, and an all-zero ``real`` gives NaN (undefined, surfaced).
    ``dim`` takes one MAPE a row along that dimension (a fleet's lanes)
    instead of one over every element.
    """
    nonzero = real.abs() > eps
    n = nonzero.sum() if dim is None else nonzero.sum(dim)
    ape = ((real - sim) / (real.abs() + eps)).abs()
    kept = torch.where(nonzero, ape, torch.zeros_like(ape))
    total = kept.sum() if dim is None else kept.sum(dim)
    out = total / n.clamp(min=1).to(total.dtype)
    return torch.where(n > 0, out, torch.full_like(out, float("nan"))) * 100.0
