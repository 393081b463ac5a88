"""What the per-layer readers share: device time a unit, idle share and a
kernel's roofline share from the count formulas."""

from __future__ import annotations

import importlib

from twinbench.harness.device import PEAK_F32_FLOPS, PEAK_HBM_BYTES_PER_S


def per_unit_ms(seconds: float, run: dict):
    n = run.get("units") or 0
    return seconds / n * 1e3 if n and seconds > 0 else None


def idle_percent(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return (1.0 - trace.busy_s / trace.window_s) * 100.0


def roofline_percent(trace, run: dict, kernel: str, name_part: str):
    """The kernel's bound over its device time, in %: the bound of each
    launch is the larger of its operations over the f32 peak and its bytes
    over the HBM peak (``twinbench/counts/<kernel>.py``)."""
    launches = run.get("launches", {}).get(kernel)
    seconds = trace.kernel_s(name_part)
    if not launches or seconds <= 0:
        return None
    count = importlib.import_module(f"twinbench.counts.{kernel}")
    bound = sum(max(count.ops(**x) / PEAK_F32_FLOPS, count.nbytes(**x) / PEAK_HBM_BYTES_PER_S)
                for x in launches)
    return bound / seconds * 100.0
