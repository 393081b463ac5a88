"""The twin core of the port: DES, power models, calibration, the closed
loop and the batched what-if engine."""

from repro_torch.core.calibrate import CalibrationSpec, calibrate_traced, candidate_grid
from repro_torch.core.desim import (
    Prediction,
    SimOutput,
    predict_metrics,
    simulate,
    simulate_utilization,
)
from repro_torch.core.feedback import (
    HITLGate,
    Proposal,
    ProposalKind,
    propose_from_scenario,
    propose_from_state,
)
from repro_torch.core.orchestrator import (
    Clock,
    Orchestrator,
    OrchestratorConfig,
    WhatIfResult,
    WindowRecord,
)
from repro_torch.core.power import PowerParams, mape
from repro_torch.core.scenarios import (
    Scenario,
    ScenarioSet,
    ScenarioSummary,
    build_scenario_set,
    evaluate_scenarios,
    run_scenarios,
    summarize_scenarios,
)
from repro_torch.core.twin import DigitalTwin, TraceGroundTruth, TwinRunResult, run_surf_experiment

__all__ = [
    "CalibrationSpec", "calibrate_traced", "candidate_grid",
    "Prediction", "SimOutput", "predict_metrics", "simulate",
    "simulate_utilization",
    "HITLGate", "Proposal", "ProposalKind", "propose_from_scenario",
    "propose_from_state",
    "Clock", "Orchestrator", "OrchestratorConfig", "WhatIfResult",
    "WindowRecord",
    "PowerParams", "mape",
    "Scenario", "ScenarioSet", "ScenarioSummary", "build_scenario_set",
    "evaluate_scenarios", "run_scenarios", "summarize_scenarios",
    "DigitalTwin", "TraceGroundTruth", "TwinRunResult", "run_surf_experiment",
]
