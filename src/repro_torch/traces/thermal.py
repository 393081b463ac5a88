"""Ambient-temperature validation and the dynamic PUE/cooling model.

Port of ``repro.traces.thermal``: ambient-temperature validation, the CSV
loader and the synthetic diurnal generator (numpy, seeded exactly as the
JAX package), and the PUE model

    pue_t = base + amb_coeff * max(ambient_t - amb_ref, 0)
                 + load_coeff * (1 - load_frac_t)

``PUEParams()`` is the exact identity (facility power == IT power).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.traces.carbon import _resample, read_trace_csv
from repro_torch.traces.schema import SAMPLE_SECONDS

#: day length in 5-min bins
BINS_PER_DAY = int(24 * 3600 / SAMPLE_SECONDS)  # 288

#: plausible outdoor-air band, °C; values outside trigger a units warning.
TYPICAL_RANGE = (-40.0, 60.0)


def validate_ambient(ambient: np.ndarray,
                     t_bins: int | None = None) -> np.ndarray:
    """Validate an ambient trace: 1-D, finite, length T; contiguous f32."""
    arr = np.asarray(ambient, np.float32)
    if arr.ndim != 1:
        raise ValueError(f"ambient trace must be [T], got shape {arr.shape}")
    if arr.size == 0:
        raise ValueError("ambient trace is empty")
    if not np.isfinite(arr).all():
        raise ValueError("ambient trace contains non-finite values")
    if t_bins is not None and arr.shape[0] != t_bins:
        raise ValueError(
            f"ambient trace has {arr.shape[0]} bins, horizon needs {t_bins}"
            " (use load_ambient(..., t_bins=...) to resample)")
    if float(arr.min()) < TYPICAL_RANGE[0] or float(arr.max()) > TYPICAL_RANGE[1]:
        warnings.warn(
            f"ambient trace spans [{arr.min():.0f}, {arr.max():.0f}] °C, "
            f"outside the plausible outdoor band {TYPICAL_RANGE} — "
            "check the input units (Kelvin/Fahrenheit?)",
            stacklevel=2)
    return np.ascontiguousarray(arr)


def load_ambient(path: str, t_bins: int | None = None) -> np.ndarray:
    """Load a ``[T]`` °C ambient trace from a CSV-ish file
    (:func:`repro_torch.traces.carbon.read_trace_csv`); with ``t_bins`` it
    is tiled or truncated to the horizon."""
    arr = validate_ambient(read_trace_csv(path))
    if t_bins is not None:
        arr = _resample(arr, t_bins)
    return arr


def make_diurnal_ambient(
    t_bins: int,
    *,
    base: float = 16.0,
    amplitude: float = 8.0,
    wander_daily_sigma: float = 0.5,
    seed: int | None = 0,
) -> np.ndarray:
    """Synthetic diurnal ambient-temperature trace ``[t_bins]`` (°C): a
    sinusoid peaking mid-afternoon plus a per-day additive wander
    (``seed=None`` disables it)."""
    if t_bins <= 0:
        raise ValueError(f"t_bins must be positive, got {t_bins}")
    tod = (np.arange(t_bins) % BINS_PER_DAY) / BINS_PER_DAY
    out = base + amplitude * np.sin(2.0 * np.pi * (tod * 24.0 - 9.0) / 24.0)
    if seed is not None and wander_daily_sigma > 0:
        rng = np.random.default_rng(seed)
        n_days = -(-t_bins // BINS_PER_DAY)
        daily = rng.normal(0.0, wander_daily_sigma, n_days)
        out = out + np.repeat(daily, BINS_PER_DAY)[:t_bins]
    return validate_ambient(out.astype(np.float32), t_bins)


@dataclasses.dataclass(frozen=True)
class PUEParams:
    """Parameters of the dynamic PUE model (Python scalars).

    ``base >= 1`` is the best-case facility overhead, ``amb_coeff`` the
    cooling penalty per °C above ``amb_ref``, ``load_coeff`` the partial-load
    penalty at zero IT utilization (both >= 0).
    """

    base: float = 1.0
    amb_coeff: float = 0.0
    amb_ref: float = 18.0
    load_coeff: float = 0.0

    def __post_init__(self):
        b = np.asarray(self.base, np.float64)
        if b.size and (~np.isfinite(b) | (b < 1.0)).any():
            raise ValueError(
                f"PUE base must be >= 1 (facility/IT power ratio), "
                f"got {float(np.min(b))}")
        for name in ("amb_coeff", "load_coeff"):
            v = np.asarray(getattr(self, name), np.float64)
            if v.size and (~np.isfinite(v) | (v < 0)).any():
                raise ValueError(
                    f"PUE {name} must be finite and >= 0, "
                    f"got {float(np.min(v))}")
        if not np.isfinite(np.asarray(self.amb_ref, np.float64)).all():
            raise ValueError("PUE amb_ref must be finite °C")


def dynamic_pue(load_frac: torch.Tensor, ambient_c: torch.Tensor | None,
                params: PUEParams) -> torch.Tensor:
    """Per-bin PUE ``[T]`` from IT load and (optionally) the ambient trace."""
    load = load_frac.clamp(0.0, 1.0)
    pue = params.base + params.load_coeff * (1.0 - load)
    if ambient_c is not None:
        amb = ambient_c.to(load.dtype)
        pue = pue + params.amb_coeff * (amb - params.amb_ref).clamp(min=0.0)
    return pue
