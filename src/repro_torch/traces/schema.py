"""Workload-trace schema (port of ``repro.traces.schema``).

A trace is a struct-of-arrays over jobs held as torch tensors, directly
consumable by the DES in :mod:`repro_torch.core.desim`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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

    def cpu_hours(self) -> torch.Tensor:
        """Total CPU-hours per job (core-hours, the SURF-22 reporting unit)."""
        hours = self.duration_bins.to(torch.float32) * (SAMPLE_SECONDS / 3600.0)
        return torch.where(self.valid, hours * self.cores.to(torch.float32),
                           torch.zeros_like(hours))


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


def pad_workload(w: Workload, to_jobs: int) -> Workload:
    """Pad a workload to a fixed job count (padding jobs are invalid and
    never submitted: submit sentinel ``int32.max // 4``)."""
    j = w.num_jobs
    if j >= to_jobs:
        return w
    pad = to_jobs - j

    def _pad(x, fill):
        tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    return Workload(
        submit_bin=_pad(w.submit_bin, np.iinfo(np.int32).max // 4),
        duration_bins=_pad(w.duration_bins, 1),
        cores=_pad(w.cores, 1),
        util_levels=_pad(w.util_levels, 0.0),
        valid=_pad(w.valid, False),
        deferrable=(None if w.deferrable is None
                    else _pad(w.deferrable, False)),
    )


def stack_workloads(ws: "list[Workload] | tuple[Workload, ...]") -> Workload:
    """Stack S workloads into one batched Workload with leaves ``[S, J, ...]``.

    Workloads with differing job counts are first padded
    (:func:`pad_workload`) to the common maximum.  ``deferrable`` is
    stacked when every workload has it, and dropped (all deferrable) when
    none has; a mix raises.
    """
    if not ws:
        raise ValueError("need at least one workload to stack")
    to_jobs = max(w.num_jobs for w in ws)
    padded = [pad_workload(w, to_jobs) for w in ws]
    has_defer = {w.deferrable is not None for w in padded}
    if len(has_defer) > 1:
        raise ValueError("cannot stack workloads with and without deferrable")
    fields = [f.name for f in dataclasses.fields(Workload)]
    return Workload(**{
        k: (None if getattr(padded[0], k) is None
            else torch.stack([getattr(w, k) for w in padded]))
        for k in fields})


def host_mask(num_hosts, max_hosts: int) -> torch.Tensor:
    """Active-host mask(s) ``[..., max_hosts]`` for a padded host axis.

    ``num_hosts`` may be a scalar (one mask) or an ``[S]`` vector (a mask
    per scenario); the mask lies on ``num_hosts``' device (a tensor's, or
    the CPU).
    """
    n = torch.as_tensor(num_hosts, dtype=torch.int32)
    return torch.arange(max_hosts, dtype=torch.int32, device=n.device) < n[..., None]
