"""The twin core of the port: DES, power models, calibration, the closed
loop and its checkpoints, fleets of twins, the batched what-if engine, the
scenario optimizer and the multi-model combiner.  Fleets and what-if
batches split their lanes over a device mesh (``fleet_mesh``,
``scenario_mesh``) with ``shard=True``."""

from repro_torch.core.calibrate import (
    CalibrationResult,
    CalibrationSpec,
    SelfCalibrator,
    calibrate_traced,
    calibrate_window,
    candidate_grid,
)
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
    propose_from_optimum,
    propose_from_scenario,
    propose_from_state,
)
from repro_torch.core.optimize import (
    Candidate,
    ObjectiveSpec,
    OptimizeResult,
    OptimizerConfig,
    SearchSpace,
    optimize,
    score_batch,
)
from repro_torch.core.orchestrator import (
    Clock,
    OptimizeWhatIfResult,
    Orchestrator,
    OrchestratorConfig,
    WhatIfResult,
    WindowRecord,
)
from repro_torch.core.power import (
    POWER_MODELS,
    PowerParams,
    carbon_gco2,
    datacenter_power,
    energy_kwh,
    linear_power,
    mape,
    opendc_power,
    validate_power_params,
)
from repro_torch.core.scenarios import (
    SCENARIO_AXIS,
    Scenario,
    ScenarioSet,
    ScenarioSummary,
    build_scenario_set,
    evaluate_scenarios,
    run_scenarios,
    scenario_mesh,
    summarize_scenarios,
)
from repro_torch.core.slo import NFR1, SLO, BiasTracker, SLOMonitor
from repro_torch.core.state import (
    SimSlice,
    TelemetrySlice,
    TwinConfig,
    TwinState,
    WindowOutput,
    empty_telemetry,
    init_twin_state,
    load_state,
    make_telemetry,
    save_state,
    state_from_bytes,
    state_to_bytes,
    twin_step,
    twin_step_lanes,
)
from repro_torch.core.telemetry import (
    AMBIENT_KEY,
    CARBON_INTENSITY_KEY,
    PRICE_KEY,
    TelemetryStore,
    TelemetryWindow,
    clip_to_window,
)
from repro_torch.core.twin import (
    FLEET_AXIS,
    DigitalTwin,
    TraceGroundTruth,
    TwinRunResult,
    fleet_mesh,
    fleet_step,
    fleet_step_masked,
    index_twin_state,
    run_fleet,
    run_surf_experiment,
    stack_twin_states,
    update_twin_state_lane,
)

__all__ = [
    "CalibrationResult", "CalibrationSpec", "SelfCalibrator",
    "calibrate_traced", "calibrate_window", "candidate_grid",
    "Prediction", "SimOutput", "predict_metrics", "simulate",
    "simulate_utilization",
    "HITLGate", "Proposal", "ProposalKind",
    "propose_from_optimum", "propose_from_scenario", "propose_from_state",
    "Candidate", "ObjectiveSpec", "OptimizeResult", "OptimizerConfig",
    "SearchSpace", "optimize", "score_batch",
    "OptimizeWhatIfResult",
    "Clock", "Orchestrator", "OrchestratorConfig", "WhatIfResult",
    "WindowRecord",
    "SCENARIO_AXIS", "Scenario", "ScenarioSet", "ScenarioSummary",
    "build_scenario_set", "evaluate_scenarios", "run_scenarios",
    "scenario_mesh", "summarize_scenarios",
    "POWER_MODELS", "PowerParams", "carbon_gco2", "datacenter_power",
    "energy_kwh", "linear_power", "mape", "opendc_power",
    "validate_power_params",
    "NFR1", "SLO", "BiasTracker", "SLOMonitor",
    "SimSlice", "TelemetrySlice", "TwinConfig", "TwinState", "WindowOutput",
    "empty_telemetry", "init_twin_state", "load_state", "make_telemetry",
    "save_state", "state_from_bytes", "state_to_bytes", "twin_step",
    "twin_step_lanes",
    "AMBIENT_KEY", "CARBON_INTENSITY_KEY", "PRICE_KEY", "TelemetryStore",
    "TelemetryWindow", "clip_to_window",
    "DigitalTwin", "TraceGroundTruth", "TwinRunResult", "run_surf_experiment",
    "FLEET_AXIS", "fleet_mesh", "fleet_step", "fleet_step_masked",
    "index_twin_state", "run_fleet",
    "stack_twin_states", "update_twin_state_lane",
]
