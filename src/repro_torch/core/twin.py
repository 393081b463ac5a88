"""DigitalTwin facade: the whole OpenDT loop in one object (port of ``repro.core.twin``).

Wires the physical-twin telemetry source, the Orchestrator and the HITL
gate into the closed cycle of Figure 1.  ``TraceGroundTruth`` replays a
workload trace with synthesized hidden-model telemetry (experiments
E1/E2).

Fleet twinning: D independent datacenters twinned a window at a time by
one batched step (:func:`fleet_step`, :func:`fleet_step_masked`,
:func:`run_fleet`), the JAX package's ``jax.vmap(twin_step)`` with the
lane axis written out (:func:`repro_torch.core.state.twin_step_lanes`).
A fleet state is a :class:`TwinState` whose leaves lead with ``[D]``.
With ``shard=True`` the lanes split over a device mesh
(:func:`fleet_mesh`, :mod:`repro_torch.parallel.sharding`), the JAX
package's ``shard_map`` over :data:`FLEET_AXIS`.
Nothing here writes into a fleet's tensors: every function returns new
ones, so a lane view taken earlier (:func:`index_twin_state`) never
changes under its holder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.desim import simulate_utilization
from repro_torch.core.feedback import HITLGate, Proposal
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig, WindowRecord
from repro_torch.core.power import PowerParams
from repro_torch.core.slo import SLOReport
from repro_torch.core.state import (
    SimSlice,
    TelemetrySlice,
    TwinState,
    WindowOutput,
    state_leaf_names,
    state_leaves,
    state_with_leaves,
    twin_step_lanes,
)
from repro_torch.core.telemetry import TelemetryWindow, clip_to_window
from repro_torch.parallel.sharding import (
    Mesh,
    gather_lanes,
    lane_devices,
    lane_mesh,
    shard_lanes,
)
from repro_torch.traces.surf import GroundTruthSpec, synthesize_ground_truth

Tensor = torch.Tensor


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


# -- fleet twinning: the lane axis of twin_step written out -------------------

def stack_twin_states(states: "list[TwinState] | tuple[TwinState, ...]") -> TwinState:
    """Stack D independent twins into one fleet state, leaves ``[D, ...]``.

    Every state must share one :class:`TwinConfig` and the same leaf
    shapes, checked up front: a mismatch names the offending leaf and lane.
    """
    if not states:
        raise ValueError("need at least one TwinState to stack")
    cfg = states[0].cfg
    names, ref = state_leaf_names(states[0]), state_leaves(states[0])
    for lane, s in enumerate(states[1:], start=1):
        if s.cfg != cfg:
            raise ValueError(
                "fleet states must share one TwinConfig (got differing "
                f"configs:\n  {cfg}\n  {s.cfg})")
        if state_leaf_names(s) != names:
            raise ValueError(
                f"fleet states must share one structure; lane {lane} "
                "differs from lane 0 (a field present on one side only, "
                "e.g. sim_u)")
        for name, a, b in zip(names, ref, state_leaves(s)):
            if tuple(a.shape) != tuple(b.shape):
                raise ValueError(
                    f"fleet states must share leaf shapes; leaf {name} has "
                    f"shape {tuple(b.shape)} in lane {lane} vs "
                    f"{tuple(a.shape)} in lane 0")
    stacked = [torch.stack(xs, dim=0)
               for xs in zip(*(state_leaves(s) for s in states))]
    return state_with_leaves(stacked, cfg)


def index_twin_state(fleet: TwinState, i: int) -> TwinState:
    """One twin's state of a fleet state (views of lane ``i``)."""
    return state_with_leaves([x[i] for x in state_leaves(fleet)], fleet.cfg)


def update_twin_state_lane(fleet: TwinState, i: int, state: TwinState, *,
                           in_place: bool = False) -> TwinState:
    """A fleet state with lane ``i`` replaced by ``state``.

    The admission half of lane multiplexing (:mod:`repro_torch.serve.batching`);
    :func:`index_twin_state` is the eviction half.  Config- and
    shape-checked like :func:`stack_twin_states`.  The fleet's tensors are
    not written: the result holds new ones, so views of the old fleet
    (a dispatched batch's successor lanes) keep their values.  With
    ``in_place=True`` lane ``i`` of the fleet's own tensors is written and
    ``fleet`` returned: only for a fleet whose tensors nothing else holds.
    """
    if state.cfg != fleet.cfg:
        raise ValueError(
            "lane state must share the fleet's TwinConfig (got differing "
            f"configs:\n  {fleet.cfg}\n  {state.cfg})")
    if state_leaf_names(state) != state_leaf_names(fleet):
        raise ValueError(
            f"lane {i} state must share the fleet's structure "
            "(a field present on one side only, e.g. sim_u)")
    names = state_leaf_names(fleet)
    for name, f, s in zip(names, state_leaves(fleet), state_leaves(state)):
        if tuple(f.shape[1:]) != tuple(s.shape):
            raise ValueError(
                f"lane {i} state leaf {name} has shape {tuple(s.shape)}; the "
                f"fleet carries {tuple(f.shape)} (want {tuple(f.shape[1:])} "
                "per lane)")
    leaves = state_leaves(fleet)
    if not in_place:
        leaves = [f.clone() for f in leaves]
    for f, s in zip(leaves, state_leaves(state)):
        f[i].copy_(s)
    return fleet if in_place else state_with_leaves(leaves, fleet.cfg)


#: the JAX package's name of the fleet step: ``fleet_step(fleet,
#: telemetry, sim_slices)`` advances every lane; it is the lane step itself
fleet_step = twin_step_lanes


def fleet_step_masked(fleet: TwinState, telemetry: TelemetrySlice,
                      sim_slices: SimSlice, lane_active: "Tensor | None" = None,
                      *, shard: bool = False, mesh: "Mesh | None" = None
                      ) -> tuple[TwinState, WindowOutput]:
    """Advance the active lanes of a fleet one window (the serving primitive
    behind :class:`repro_torch.serve.TwinService`).

    ``fleet`` leaves lead with ``[D]``, ``telemetry``/``sim_slices`` are one
    window's slices with ``[D, ...]`` leaves and ``lane_active`` the
    ``[D]`` bool fill mask (default: every lane); see
    :func:`~repro_torch.core.state.twin_step_lanes`, which this is.

    With ``shard=True`` the D axis is split over ``mesh`` (default:
    :func:`fleet_mesh` over every device of the fleet's kind): D pads to a
    multiple of the mesh's entries with replicas of lane 0, its fill mask
    too (at least 2 lanes an entry when there is more than one), each entry
    steps its contiguous shard on its device, one ``des_readout`` and
    ``1 + refine_iters`` ``calib_mape_grid`` launches an entry, and the
    outputs come back in lane order on the fleet's device, cut to the
    true D, equal bit for bit to the unsharded step.  A ``mesh`` without
    ``shard=True`` raises.
    """
    if not shard:
        if mesh is not None:
            raise ValueError("mesh given but shard=False")
        return twin_step_lanes(fleet, telemetry, sim_slices, lane_active)
    if lane_active is not None:
        lane_active = torch.as_tensor(lane_active, dtype=torch.bool,
                                      device=fleet.window.device)
    shards = _split(fleet, (telemetry, sim_slices, lane_active), 0, mesh)
    return _gather([twin_step_lanes(f, *i) for f, i in shards], fleet, 0)


def _window(x, w: int):
    return None if x is None else x[w]


def _stack_outputs(outs: "list[WindowOutput]") -> WindowOutput:
    def st(*xs):
        return None if xs[0] is None else torch.stack(xs, dim=0)

    def params(ps):
        return PowerParams(*(st(*(getattr(p, f) for p in ps))
                             for f in ("p_idle", "p_max", "r")))

    preds = [o.prediction for o in outs]
    pred = type(preds[0])(**{f.name: st(*(getattr(p, f.name) for p in preds))
                             for f in dataclasses.fields(preds[0])})
    return WindowOutput(
        prediction=pred, mape=st(*(o.mape for o in outs)),
        calib_mape=st(*(o.calib_mape for o in outs)),
        params_used=params([o.params_used for o in outs]),
        params_next=params([o.params_next for o in outs]),
        window=st(*(o.window for o in outs)))


def _run_windows(fleet: TwinState, telemetry: TelemetrySlice,
                 sim_slices: SimSlice) -> tuple[TwinState, WindowOutput]:
    n = telemetry.u_th.shape[0]
    outs = []
    for w in range(n):
        fleet, out = fleet_step(
            fleet,
            TelemetrySlice(u_th=telemetry.u_th[w], power_w=telemetry.power_w[w],
                           valid=telemetry.valid[w]),
            SimSlice(**{f.name: _window(getattr(sim_slices, f.name), w)
                        for f in dataclasses.fields(sim_slices)}))
        outs.append(out)
    return fleet, _stack_outputs(outs)


def run_fleet(fleet: TwinState, telemetry: TelemetrySlice,
              sim_slices: SimSlice, *, shard: bool = False,
              mesh: "Mesh | None" = None) -> tuple[TwinState, WindowOutput]:
    """Twin a whole fleet over a whole horizon, a batched step a window.

    ``telemetry``/``sim_slices`` leaves lead with ``[W, D, ...]`` (windows,
    datacenters).  Each window is one :func:`fleet_step`, so the run
    launches W ``des_readout`` and W x (1 + refine_iters)
    ``calib_mape_grid``, not D times as many.  Returns the final fleet
    state and the outputs stacked ``[W, D, ...]``; each lane is its solo
    run.

    With ``shard=True`` the D axis (axis 1 of the inputs) is split over
    ``mesh`` as :func:`fleet_step_masked` splits it, padded with replicas
    of lane 0, each entry running every window of its shard: W launches of
    each kernel an entry, and results equal bit for bit to the unsharded
    run.  A ``mesh`` without ``shard=True`` raises.
    """
    if not shard:
        if mesh is not None:
            raise ValueError("mesh given but shard=False")
        return _run_windows(fleet, telemetry, sim_slices)
    shards = _split(fleet, (telemetry, sim_slices), 1, mesh)
    return _gather([_run_windows(f, *i) for f, i in shards], fleet, 1)


# -- fleet-axis sharding over a device mesh ------------------------------------

#: mesh axis name the fleet (lane) axis is sharded over
FLEET_AXIS = "fleet"


def fleet_mesh(num_devices: "int | None" = None, *,
               device: "str | torch.device" = "cuda") -> Mesh:
    """A 1-D mesh over :data:`FLEET_AXIS`: every card by default (the
    first ``num_devices`` otherwise, more than the host has raising), or
    ``num_devices`` CPU entries (default 1) with ``device="cpu"``."""
    return lane_mesh(FLEET_AXIS, num_devices, device)


def _split(fleet: TwinState, inputs: tuple, in_axis: int,
           mesh: "Mesh | None") -> "zip":
    """``(fleet shard, input shards)`` an entry of ``mesh`` (default: every
    device of the fleet's kind); the inputs' lanes on ``in_axis``."""
    if mesh is None:
        mesh = fleet_mesh(device=fleet.window.device.type)
    devices = lane_devices(mesh, FLEET_AXIS)
    d = fleet.window.shape[0]
    return zip(shard_lanes(fleet, devices, d, 0, "fleet"),
               shard_lanes(inputs, devices, d, in_axis, "fleet inputs"))


def _gather(results: list, fleet: TwinState, out_axis: int
            ) -> tuple[TwinState, WindowOutput]:
    """The shards' successor fleets and outputs (lanes on ``out_axis``) on
    the fleet's device, cut to its D lanes."""
    d, home = fleet.window.shape[0], fleet.window.device
    return (gather_lanes([r[0] for r in results], d, 0, home),
            gather_lanes([r[1] for r in results], d, out_axis, home))
