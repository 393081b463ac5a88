"""Electricity spot-price validation ($/kWh at the 5-minute granularity).

Port of ``repro.traces.price.validate_price``: negative prices are allowed
(spot markets clear below zero), non-finite ones are not.
"""

from __future__ import annotations

import warnings

import numpy as np

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
            f"price trace has {arr.shape[0]} bins, horizon needs {t_bins}")
    if float(arr.max()) > TYPICAL_MAX:
        warnings.warn(
            f"price trace peaks at {arr.max():.2f} $/kWh, above the "
            f"plausible band (<= {TYPICAL_MAX}) — check the input units "
            "($/MWh?)", stacklevel=2)
    return np.ascontiguousarray(arr)
