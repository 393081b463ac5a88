"""Workload-trace schema (port of ``repro.traces.schema``).

A trace is a struct-of-arrays over jobs held as torch tensors, directly
consumable by the DES in :mod:`repro_torch.core.desim`.
"""

from __future__ import annotations

import dataclasses

import torch

#: industry-standard sampling granularity used throughout the paper (§3.3).
SAMPLE_SECONDS = 300.0  # 5 minutes


@dataclasses.dataclass(frozen=True)
class Workload:
    """A job trace, struct-of-arrays, SURF-22 shaped.

    Attributes:
      submit_bin: ``[J] int32`` submission time, in 5-min bins from t0.
      duration_bins: ``[J] int32`` runtime in bins.
      cores: ``[J] int32`` cores requested (single-host jobs).
      util_levels: ``[J, U] float32`` piecewise per-core utilization
        profile over U equal-length phases.
      valid: ``[J] bool`` padding mask.
      deferrable: ``[J] bool`` or ``None`` (all jobs deferrable).
    """

    submit_bin: torch.Tensor
    duration_bins: torch.Tensor
    cores: torch.Tensor
    util_levels: torch.Tensor
    valid: torch.Tensor
    deferrable: torch.Tensor | None = None

    @property
    def num_jobs(self) -> int:
        return int(self.submit_bin.shape[0])

    @property
    def num_phases(self) -> int:
        return int(self.util_levels.shape[1])

    @property
    def device(self) -> torch.device:
        return self.submit_bin.device

    def to(self, device: "str | torch.device") -> "Workload":
        """The same trace with every tensor on ``device``."""
        return Workload(*(None if x is None else x.to(device)
                          for x in dataclasses.astuple(self)))


@dataclasses.dataclass(frozen=True)
class DatacenterConfig:
    """Static topology of the twinned datacenter (paper §3.2: SURF-SARA)."""

    num_hosts: int = 277
    cores_per_host: int = 16
    ghz: float = 2.1
    mem_gb: float = 128.0
    #: double-precision FLOPs per core per cycle (FMA width)
    flops_per_cycle: float = 16.0

    @property
    def peak_tflops(self) -> float:
        """Peak datacenter TFLOP/s at 100 % utilization."""
        return (
            self.num_hosts * self.cores_per_host * self.ghz * 1e9 * self.flops_per_cycle
        ) / 1e12
