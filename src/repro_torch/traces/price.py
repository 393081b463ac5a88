"""Electricity spot-price traces ($/kWh at the 5-minute granularity).

Port of ``repro.traces.price``: validation (negative prices are allowed,
spot markets clear below zero; non-finite ones are not), the CSV loader
and the synthetic diurnal generator (numpy, seeded exactly as the JAX
package), shaped opposite to the carbon generator's midday dip.
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.traces.carbon import _resample, read_trace_csv
from repro_torch.traces.schema import SAMPLE_SECONDS

#: day length in 5-min bins
BINS_PER_DAY = int(24 * 3600 / SAMPLE_SECONDS)  # 288

#: plausible retail/spot band, $/kWh; values above trigger a units warning.
TYPICAL_MAX = 5.0


def validate_price(price: np.ndarray, t_bins: int | None = None) -> np.ndarray:
    """Validate a price trace: 1-D, finite, length T; contiguous f32."""
    arr = np.asarray(price, np.float32)
    if arr.ndim != 1:
        raise ValueError(f"price trace must be [T], got shape {arr.shape}")
    if arr.size == 0:
        raise ValueError("price trace is empty")
    if not np.isfinite(arr).all():
        raise ValueError("price trace contains non-finite values")
    if t_bins is not None and arr.shape[0] != t_bins:
        raise ValueError(
            f"price trace has {arr.shape[0]} bins, horizon needs {t_bins}"
            " (use load_price_trace(..., t_bins=...) to resample)")
    if float(arr.max()) > TYPICAL_MAX:
        warnings.warn(
            f"price trace peaks at {arr.max():.2f} $/kWh, above the "
            f"plausible band (<= {TYPICAL_MAX}) — check the input units "
            "($/MWh?)", stacklevel=2)
    return np.ascontiguousarray(arr)


def load_price_trace(path: str, t_bins: int | None = None) -> np.ndarray:
    """Load a ``[T]`` $/kWh spot-price trace from a CSV-ish file
    (:func:`repro_torch.traces.carbon.read_trace_csv`); with ``t_bins`` it
    is tiled or truncated to the horizon."""
    arr = validate_price(read_trace_csv(path))
    if t_bins is not None:
        arr = _resample(arr, t_bins)
    return arr


def make_diurnal_price(
    t_bins: int,
    *,
    base: float = 0.10,
    night_discount: float = 0.06,
    evening_peak: float = 0.15,
    wander_daily_sigma: float = 0.05,
    seed: int | None = 0,
) -> np.ndarray:
    """Synthetic diurnal spot-price trace ``[t_bins]`` ($/kWh): cheap
    overnight (~03:00), an expensive evening ramp (~19:00), and a per-day
    lognormal wander (``seed=None`` disables it)."""
    if t_bins <= 0:
        raise ValueError(f"t_bins must be positive, got {t_bins}")
    tod = (np.arange(t_bins) % BINS_PER_DAY) / BINS_PER_DAY
    hours = tod * 24.0
    night = np.exp(-0.5 * ((hours - 3.0) / 2.5) ** 2)
    evening = np.exp(-0.5 * ((hours - 19.0) / 2.0) ** 2)
    out = base - night_discount * night + evening_peak * evening
    if seed is not None and wander_daily_sigma > 0:
        rng = np.random.default_rng(seed)
        n_days = -(-t_bins // BINS_PER_DAY)
        daily = rng.lognormal(0.0, wander_daily_sigma, n_days)
        out = out * np.repeat(daily, BINS_PER_DAY)[:t_bins]
    return validate_price(out.astype(np.float32), t_bins)
