"""Three-term roofline over a step's counted cost, on an NVIDIA H100.

Hardware model (H100 SXM5 80GB, NVIDIA datasheet, dense, 700 W; the card
``chip_smoke.py`` runs on):
  peak bf16 tensor-core compute  989.4 TFLOP/s
  HBM3 bandwidth                 3.35 TB/s
  NVLink                         450 GB/s a direction

Terms (seconds, per device; the roofline lower-bounds step latency):
  compute    = FLOPs / peak
  memory     = bytes / HBM bandwidth
  collective = wire bytes / NVLink bandwidth, or None where the wire bytes
               are not modelled (one process issues no collectives:
               ``analysis/cost.py``); ``dominant`` and ``bound_s`` then
               take the other two terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989.4e12      # bf16 FLOP/s per card
HBM_BW = 3.35e12           # bytes/s per card
NVLINK_BW = 450e9          # bytes/s per card, one direction


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float | None
    flops: float
    bytes: float
    wire_bytes: float | None
    model_flops: float          # 6 * N(_active) * D, global
    chips: int

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat and redundant work."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: how close the step's useful
        math runs to the roofline if the bound is achieved."""
        useful_s = self.model_flops / (self.chips * PEAK_FLOPS)
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "model_flops_global": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def make_roofline(parsed: dict[str, Any], model_flops: float,
                  chips: int) -> Roofline:
    f = parsed["flops_per_device"]
    b = parsed["bytes_per_device"]
    w = parsed["collective_wire_bytes_per_device"]
    return Roofline(
        compute_s=f / PEAK_FLOPS,
        memory_s=b / HBM_BW,
        collective_s=None if w is None else w / NVLINK_BW,
        flops=f, bytes=b, wire_bytes=w,
        model_flops=model_flops, chips=chips,
    )


def model_flops_for(cfg, shape_kind: str, batch: int, seq: int,
                    train: bool) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode processes batch tokens."""
    from repro_torch.configs.base import active_param_count

    n = active_param_count(cfg)
    if shape_kind == "train":
        d = batch * seq
        return 6.0 * n * d
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence
