"""The card a run measures: its presence, name, power limit and peaks."""

from __future__ import annotations

import shutil
import subprocess
import sys

#: published NVIDIA H100 SXM peaks (data sheet, dense, at 700 W): float32
#: FLOP/s outside the tensor cores and HBM3 bytes/s
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def require_cards(torch, chips: int) -> None:
    """Exit with code 3, printing no result, unless ``chips`` cards are
    visible: the benchmark never falls back to the CPU."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"twinbench: needs {chips} CUDA device(s), torch sees {have} "
              f"(torch.cuda.is_available() is {torch.cuda.is_available()})",
              file=sys.stderr)
        sys.exit(3)


def power_limit() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def describe(torch, device, chips: int, peak_bytes: int) -> dict:
    """The result's ``device`` entry."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def memory_peak(torch, device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
