"""SLO definitions and monitors (port of ``repro.core.slo``).

NFR1 (paper §2.1): prediction error (MAPE) must stay below 10 % for at
least 90 % of the operational time.  The functional accumulators
(:func:`observe_slos`, :func:`observe_bias`) update integer count tensors
inside ``twin_step``; the imperative monitors hydrate from those counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SLO:
    """A service-level objective over a telemetry-derived series."""

    name: str
    metric: str
    threshold: float
    comparison: str = "lt"       # lt | le | gt | ge
    min_compliance: float = 0.90

    def holds(self, value: float) -> bool:
        return {
            "lt": value < self.threshold,
            "le": value <= self.threshold,
            "gt": value > self.threshold,
            "ge": value >= self.threshold,
        }[self.comparison]


#: NFR1 exactly as stated in the paper.
NFR1 = SLO(name="NFR1-accuracy", metric="mape", threshold=10.0,
           comparison="lt", min_compliance=0.90)


@dataclasses.dataclass
class SLOReport:
    slo: SLO
    samples: int
    compliant: int

    @property
    def compliance(self) -> float:
        return self.compliant / self.samples if self.samples else 1.0

    @property
    def met(self) -> bool:
        return self.compliance >= self.slo.min_compliance


def slo_holds(slo: SLO, value: torch.Tensor) -> torch.Tensor:
    """Tensor compliance check; NaN never complies."""
    return {
        "lt": lambda v: v < slo.threshold,
        "le": lambda v: v <= slo.threshold,
        "gt": lambda v: v > slo.threshold,
        "ge": lambda v: v >= slo.threshold,
    }[slo.comparison](value)


def observe_slos(slos: tuple[SLO, ...], samples: torch.Tensor,
                 compliant: torch.Tensor, value: torch.Tensor, valid: bool,
                 metric: str = "mape"):
    """One SLO-accumulator update over a shared metric stream.

    ``samples``/``compliant`` are ``[len(slos)]`` int32 tensors; only SLOs
    over ``metric`` are updated, and nothing is when ``valid`` is False.
    """
    if not slos or not valid:
        return samples, compliant
    on = torch.tensor([s.metric == metric for s in slos], dtype=torch.int32,
                      device=samples.device)
    holds = torch.stack([slo_holds(s, value).to(torch.int32) for s in slos])
    return samples + on, compliant + holds * on


def observe_bias(under, over, ties, real: torch.Tensor, sim: torch.Tensor,
                 valid: bool):
    """Directional split of ``sim`` vs ``real`` added to the counts."""
    if not valid:
        return under, over, ties
    return (under + (sim < real).sum().to(torch.int32),
            over + (sim > real).sum().to(torch.int32),
            ties + (sim == real).sum().to(torch.int32))


def observe_slos_lanes(slos: tuple[SLO, ...], samples: torch.Tensor,
                       compliant: torch.Tensor, value: torch.Tensor,
                       valid: torch.Tensor, metric: str = "mape"):
    """:func:`observe_slos` for a fleet: ``[D, len(slos)]`` counts, a ``[D]``
    metric and a ``[D]`` bool ``valid`` (lanes without telemetry keep
    their counts), with no read on the host."""
    if not slos:
        return samples, compliant
    on = torch.tensor([s.metric == metric for s in slos], dtype=torch.int32,
                      device=samples.device) * valid.to(torch.int32)[:, None]
    holds = torch.stack([slo_holds(s, value).to(torch.int32) for s in slos], dim=-1)
    return samples + on, compliant + holds * on


def observe_bias_lanes(under, over, ties, real: torch.Tensor, sim: torch.Tensor,
                       valid: torch.Tensor):
    """:func:`observe_bias` for a fleet: ``[D]`` counts, ``[D, T]`` series and
    a ``[D]`` bool ``valid``."""
    on = valid.to(torch.int32)
    return (under + (sim < real).sum(-1).to(torch.int32) * on,
            over + (sim > real).sum(-1).to(torch.int32) * on,
            ties + (sim == real).sum(-1).to(torch.int32) * on)


class SLOMonitor:
    """Streams per-sample metric values against a set of SLOs."""

    def __init__(self, slos: list[SLO]):
        self.slos = slos
        self._counts = {s.name: [0, 0] for s in slos}

    @classmethod
    def from_counts(cls, slos, samples, compliant) -> "SLOMonitor":
        """Hydrate a monitor from the core's accumulator tensors."""
        mon = cls(list(slos))
        samples = torch.as_tensor(samples).cpu().numpy()
        compliant = torch.as_tensor(compliant).cpu().numpy()
        for i, s in enumerate(mon.slos):
            mon._counts[s.name] = [int(samples[i]), int(compliant[i])]
        return mon

    def observe(self, metric: str, values) -> None:
        arr = np.atleast_1d(np.asarray(values, np.float64))
        for s in self.slos:
            if s.metric != metric:
                continue
            c = self._counts[s.name]
            c[0] += arr.size
            c[1] += int(sum(s.holds(float(v)) for v in arr))

    def report(self) -> list[SLOReport]:
        return [SLOReport(s, *self._counts[s.name]) for s in self.slos]


@dataclasses.dataclass
class BiasTracker:
    """Under/over-estimation bias of the predictive model (paper Fig. 6).

    Exact ties are counted separately; the fractions are of the
    directional samples only.
    """

    under: int = 0
    over: int = 0
    ties: int = 0

    def observe(self, real, sim) -> None:
        real = np.asarray(real)
        sim = np.asarray(sim)
        self.under += int(np.sum(sim < real))
        self.over += int(np.sum(sim > real))
        self.ties += int(np.sum(sim == real))

    @property
    def samples(self) -> int:
        return self.under + self.over + self.ties

    @property
    def directional(self) -> int:
        return self.under + self.over

    @property
    def under_fraction(self) -> float:
        return self.under / self.directional if self.directional else 0.0

    @property
    def over_fraction(self) -> float:
        return self.over / self.directional if self.directional else 0.0
