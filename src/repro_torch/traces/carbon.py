"""Grid carbon-intensity traces (gCO2 per kWh).

Port of ``repro.traces.carbon``: validation, the CSV loader resampled to
the horizon, and the synthetic diurnal generator (numpy, seeded exactly as
the JAX package).
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.traces.surf import BINS_PER_DAY

#: typical grid bounds, gCO2/kWh; values above trigger a units warning.
TYPICAL_RANGE = (0.0, 2000.0)


def validate_carbon_intensity(intensity: np.ndarray,
                              t_bins: int | None = None) -> np.ndarray:
    """Validate an intensity trace: 1-D, finite, non-negative, length T.

    Returns the trace as a contiguous float32 array; raises ``ValueError``
    on bad data.
    """
    arr = np.asarray(intensity, np.float32)
    if arr.ndim != 1:
        raise ValueError(f"carbon intensity must be [T], got shape {arr.shape}")
    if arr.size == 0:
        raise ValueError("carbon intensity trace is empty")
    if not np.isfinite(arr).all():
        raise ValueError("carbon intensity contains non-finite values")
    if (arr < 0).any():
        raise ValueError(
            f"carbon intensity must be >= 0 gCO2/kWh (min {arr.min():.1f})")
    if t_bins is not None and arr.shape[0] != t_bins:
        raise ValueError(
            f"carbon intensity has {arr.shape[0]} bins, horizon needs {t_bins}"
            " (use load_carbon_intensity(..., t_bins=...) to resample)")
    if float(arr.max()) > TYPICAL_RANGE[1]:
        warnings.warn(
            f"carbon intensity peaks at {arr.max():.0f} gCO2/kWh, above the "
            f"typical grid band {TYPICAL_RANGE} — check the input units",
            stacklevel=2)
    return np.ascontiguousarray(arr)


def _resample(arr: np.ndarray, t_bins: int) -> np.ndarray:
    """Fit a trace to the horizon: tile a shorter (periodic) trace,
    truncate a longer one."""
    if arr.shape[0] == t_bins:
        return arr
    if arr.shape[0] > t_bins:
        return arr[:t_bins]
    reps = -(-t_bins // arr.shape[0])
    return np.tile(arr, reps)[:t_bins]


def read_trace_csv(path: str) -> np.ndarray:
    """The values of a one-column or ``timestamp,value`` CSV-ish file.

    The last column of each row is taken, in file order; empty lines,
    ``#`` comments and one non-numeric header row are skipped.
    """
    vals: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cell = line.split(",")[-1].strip()
            try:
                vals.append(float(cell))
            except ValueError:
                if vals:
                    raise ValueError(
                        f"{path}: non-numeric row {line!r} after data rows")
                continue  # header row
    return np.asarray(vals, np.float32)


def load_carbon_intensity(path: str, t_bins: int | None = None) -> np.ndarray:
    """Load a ``[T]`` gCO2/kWh trace from a CSV-ish file
    (:func:`read_trace_csv`); with ``t_bins`` it is tiled if shorter
    (intensity is diurnal-periodic) and truncated if longer."""
    arr = validate_carbon_intensity(read_trace_csv(path))
    if t_bins is not None:
        arr = _resample(arr, t_bins)
    return arr


def make_diurnal_carbon(
    t_bins: int,
    *,
    base: float = 320.0,
    solar_dip: float = 180.0,
    evening_peak: float = 120.0,
    wander_daily_sigma: float = 0.04,
    seed: int | None = 0,
) -> np.ndarray:
    """Synthetic diurnal grid-carbon-intensity trace ``[t_bins]`` (gCO2/kWh)."""
    if t_bins <= 0:
        raise ValueError(f"t_bins must be positive, got {t_bins}")
    tod = (np.arange(t_bins) % BINS_PER_DAY) / BINS_PER_DAY
    solar = np.clip(np.sin(np.pi * (tod * 24.0 - 7.0) / 12.0), 0.0, None) ** 2
    evening = np.exp(-0.5 * ((tod * 24.0 - 19.5) / 1.8) ** 2)
    out = base - solar_dip * solar + evening_peak * evening
    if seed is not None and wander_daily_sigma > 0:
        rng = np.random.default_rng(seed)
        n_days = -(-t_bins // BINS_PER_DAY)
        daily = np.exp(rng.normal(0.0, wander_daily_sigma, n_days))
        out = out * np.repeat(daily, BINS_PER_DAY)[:t_bins]
    return validate_carbon_intensity(
        np.maximum(out, 0.0).astype(np.float32), t_bins)
