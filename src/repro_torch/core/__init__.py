"""The twin core of the port: DES, power models, calibration, the closed loop."""

from repro_torch.core.calibrate import CalibrationSpec, calibrate_traced, candidate_grid
from repro_torch.core.desim import Prediction, SimOutput, predict_metrics, simulate_utilization
from repro_torch.core.orchestrator import Clock, Orchestrator, OrchestratorConfig, WindowRecord
from repro_torch.core.power import PowerParams, mape
from repro_torch.core.twin import DigitalTwin, TraceGroundTruth, TwinRunResult, run_surf_experiment

__all__ = [
    "CalibrationSpec", "calibrate_traced", "candidate_grid",
    "Prediction", "SimOutput", "predict_metrics", "simulate_utilization",
    "Clock", "Orchestrator", "OrchestratorConfig", "WindowRecord",
    "PowerParams", "mape",
    "DigitalTwin", "TraceGroundTruth", "TwinRunResult", "run_surf_experiment",
]
