"""DigitalTwin facade: the whole OpenDT loop in one object (port of ``repro.core.twin``).

Wires the physical-twin telemetry source, the Orchestrator and the HITL
gate into the closed cycle of Figure 1.  ``TraceGroundTruth`` replays a
workload trace with synthesized hidden-model telemetry (experiments
E1/E2).  Fleet twinning comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.desim import simulate_utilization
from repro_torch.core.feedback import HITLGate, Proposal
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig, WindowRecord
from repro_torch.core.power import PowerParams
from repro_torch.core.slo import SLOReport
from repro_torch.core.telemetry import TelemetryWindow, clip_to_window
from repro_torch.traces.surf import GroundTruthSpec, synthesize_ground_truth


class TraceGroundTruth:
    """Physical-twin stand-in: hidden-model telemetry over a trace replay.

    The utilization field comes from the DES on the workload's device;
    the hidden-model power is synthesized on the host (numpy).
    """

    def __init__(self, workload, dc, t_bins: int, gt=None):
        gt = gt or GroundTruthSpec()
        sim = simulate_utilization(
            workload, num_hosts=dc.num_hosts,
            cores_per_host=dc.cores_per_host, t_bins=t_bins,
        )
        self.u_th = sim.u_th.cpu().numpy()
        self.power = synthesize_ground_truth(self.u_th, gt)

    def window(self, idx: int, bins_per_window: int) -> TelemetryWindow:
        return clip_to_window(idx, bins_per_window, 0, self.u_th, self.power)


@dataclasses.dataclass
class TwinRunResult:
    records: list[WindowRecord]
    overall_mape: float
    per_window_mape: np.ndarray
    slo_reports: list[SLOReport]
    under_estimation_fraction: float
    approved_proposals: list[Proposal]
    #: seconds the full-horizon DES took (device synchronized)
    des_seconds: float | None = None


class DigitalTwin:
    """OpenDT's outer loop."""

    def __init__(
        self,
        workload,
        dc,
        t_bins: int,
        cfg: OrchestratorConfig = OrchestratorConfig(),
        base_params: PowerParams = PowerParams(),
        hitl_policy: Callable[[Proposal], bool | None] | None = None,
    ):
        self.gate = HITLGate(policy=hitl_policy)
        self.orchestrator = Orchestrator(
            workload, dc, t_bins, cfg, base_params, gate=self.gate,
        )

    def run(
        self,
        telemetry_source: Callable[[int, int], TelemetryWindow],
        num_windows: int | None = None,
    ) -> TwinRunResult:
        """Run the closed loop: per window, ingest telemetry then twin it."""
        orch = self.orchestrator
        n = num_windows if num_windows is not None else orch.num_windows
        approved: list[Proposal] = []
        for w in range(n):
            tw = telemetry_source(w, orch.cfg.bins_per_window)
            orch.store.ingest(tw)
            orch.run_window(w)
            approved.extend(self.gate.drain())
        return TwinRunResult(
            records=orch.records,
            overall_mape=orch.overall_mape(),
            per_window_mape=orch.per_window_mape(),
            slo_reports=orch.monitor.report(),
            under_estimation_fraction=orch.bias.under_fraction,
            approved_proposals=approved,
            des_seconds=orch.des_seconds,
        )


def run_surf_experiment(
    workload,
    dc,
    t_bins: int,
    *,
    calibrate: bool,
    cfg: OrchestratorConfig | None = None,
    base_params: PowerParams = PowerParams(),
    gt=None,
    hitl_policy: Callable[[Proposal], bool | None] | None = None,
    device: "str | None" = None,
) -> TwinRunResult:
    """One E1/E2-style run: trace replay + hidden-model telemetry.

    ``device`` (default: ``cfg.device``, itself ``"cuda"`` by default)
    places the run: the workload moves there, and the DES, the readout
    and the calibration run there.
    """
    cfg = cfg or OrchestratorConfig()
    cfg = dataclasses.replace(cfg, calibrate=calibrate,
                              device=cfg.device if device is None else device)
    twin = DigitalTwin(workload, dc, t_bins, cfg, base_params,
                       hitl_policy=hitl_policy)
    truth = TraceGroundTruth(twin.orchestrator.workload, dc, t_bins, gt)
    return twin.run(truth.window)
