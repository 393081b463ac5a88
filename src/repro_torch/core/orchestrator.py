"""The Orchestrator (paper §2.3, component C): the I/O shell around the core.

Port of ``repro.core.orchestrator``.  All per-window math is one
:func:`~repro_torch.core.state.twin_step` on ``self.state``; this shell owns
telemetry I/O (the :class:`~repro_torch.core.telemetry.TelemetryStore`),
wall-clock pacing, run records, float64 sustainability bookkeeping and the
SLO-aware proposals routed through the human-in-the-loop gate, the
batched what-if sweep (:meth:`Orchestrator.evaluate_whatif`), the searched
what-if (:meth:`Orchestrator.optimize_whatif`) and the application of an
approved structural proposal to the twin (:meth:`Orchestrator.apply_proposal`,
paper stage 3).

Acceleration factor (paper §2.3): ratio between simulated and wall time;
``None`` runs as fast as compute allows.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.calibrate import CalibrationSpec
from repro_torch.core.desim import (
    PLACEMENT_POLICIES,
    Prediction,
    SimOutput,
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
    ObjectiveSpec,
    OptimizeResult,
    OptimizerConfig,
    SearchSpace,
    optimize,
)
from repro_torch.core.power import PowerParams, mape
from repro_torch.core.scenarios import Scenario, ScenarioSummary, evaluate_scenarios
from repro_torch.core.slo import NFR1, BiasTracker, SLOMonitor
from repro_torch.core.state import (
    SimSlice,
    TwinConfig,
    TwinState,
    empty_telemetry,
    init_twin_state,
    load_state,
    make_telemetry,
    save_state,
    twin_step,
)
from repro_torch.core.telemetry import (
    AMBIENT_KEY,
    CARBON_INTENSITY_KEY,
    PRICE_KEY,
    TelemetryStore,
)
from repro_torch.traces.carbon import validate_carbon_intensity
from repro_torch.traces.price import validate_price
from repro_torch.traces.schema import SAMPLE_SECONDS, DatacenterConfig, Workload
from repro_torch.traces.thermal import PUEParams, validate_ambient


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    bins_per_window: int = 36            # 3 h windows at 5-min sampling
    calibration: CalibrationSpec = CalibrationSpec()
    calibrate: bool = True               # E2 ablation switch
    history_windows: int = 4             # telemetry history per calibration
    acceleration: float | None = None    # None = max acceleration
    power_cap_w: float | None = None
    power_model: str = "opendc"
    #: where the twin runs: "cuda" (hand-written kernels) or "cpu"
    device: str = "cuda"
    pue: PUEParams | None = None
    #: resident DES (paper stage 3): the full-horizon utilization field
    #: lives in ``TwinState.sim_u`` and ``twin_step`` slices its own
    #: window, so an applied proposal (:meth:`Orchestrator.apply_proposal`)
    #: re-seeds the twin's own simulation.  Off by default.
    sim_in_state: bool = False


@dataclasses.dataclass(frozen=True)
class Clock:
    """Injectable wall clock for the I/O shell (records and pacing only)."""

    now: Callable[[], float] = time.time
    sleep: Callable[[float], None] = time.sleep


@dataclasses.dataclass
class WindowRecord:
    """Run metadata per window (paper §2.3: 'which outputs belong together').

    ``sim_seconds`` times the whole ``twin_step`` (prediction and
    calibration) up to a device synchronize.
    """

    window: int
    started_at: float
    sim_seconds: float
    params: PowerParams
    prediction: Prediction
    mape: float | None = None
    gco2: float | None = None
    energy_cost: float | None = None
    proposals: int = 0


@dataclasses.dataclass(frozen=True)
class WhatIfResult:
    """Outcome of one batched what-if sweep.

    ``summaries[0]`` is the baseline (current topology) when the sweep ran
    with ``include_baseline=True``; otherwise the summaries are the user's
    scenarios only (the baseline is still evaluated, so every candidate is
    compared against the current configuration).  ``proposals`` are
    already submitted to the orchestrator's HITL gate.
    """

    summaries: list[ScenarioSummary]
    proposals: list[Proposal]
    sim: SimOutput              # batched, leaves [S, ...]
    prediction: Prediction      # batched, leaves [S, ...]


@dataclasses.dataclass(frozen=True)
class OptimizeWhatIfResult:
    """Outcome of one searched what-if: the optimum plus its HITL routing.

    ``result`` is the :class:`~repro_torch.core.optimize.OptimizeResult`
    (incumbent, baseline, evaluation history, convergence trace);
    ``proposals`` are already submitted to the orchestrator's HITL gate and
    carry the optimum's objective breakdown against the baseline's.
    """

    result: OptimizeResult
    proposals: list[Proposal]


def _drop_first_lane(x):
    """A batched SimOutput or Prediction without lane 0."""
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name)[1:] for f in dataclasses.fields(x)
        if getattr(x, f.name) is not None})


def _f64(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


class Orchestrator:
    """Drives the closed loop over a trace-driven physical twin."""

    def __init__(
        self,
        workload: Workload,
        dc: DatacenterConfig,
        t_bins: int,
        cfg: OrchestratorConfig = OrchestratorConfig(),
        base_params: PowerParams = PowerParams(),
        gate: HITLGate | None = None,
        carbon_intensity: "np.ndarray | None" = None,
        ambient_c: "np.ndarray | None" = None,
        price: "np.ndarray | None" = None,
        clock: Clock | None = None,
    ):
        self.device = resolve_device(cfg.device)
        self.workload = workload.to(self.device)
        self.dc = dc
        self.t_bins = int(t_bins)
        self.cfg = cfg
        self.base_params = base_params
        if carbon_intensity is not None:
            carbon_intensity = validate_carbon_intensity(
                np.asarray(carbon_intensity), self.t_bins)
        self.carbon_intensity = carbon_intensity
        if ambient_c is not None:
            ambient_c = validate_ambient(np.asarray(ambient_c), self.t_bins)
        self.ambient_c = ambient_c
        if price is not None:
            price = validate_price(np.asarray(price), self.t_bins)
        self.price = price
        if (cfg.pue is not None and cfg.pue.amb_coeff > 0.0
                and ambient_c is None):
            raise ValueError(
                "OrchestratorConfig.pue has amb_coeff > 0 but no ambient_c "
                "trace was supplied — pass ambient_c=[t_bins] deg C or use "
                "a load-only PUE model (amb_coeff=0)")
        self.clock = clock or Clock()
        self.store = TelemetryStore(cfg.bins_per_window)
        self.gate = gate or HITLGate()
        self.records: list[WindowRecord] = []
        # scheduler knobs the twin's DES runs under; structural proposals
        # (apply_proposal) are the only writers after construction
        self.policy: str | None = None
        self.backfill_depth: int = 0
        self._sim: SimOutput | None = None
        #: seconds the last full-horizon DES took (device synchronized)
        self.des_seconds: float | None = None
        self.twin_cfg = TwinConfig(
            bins_per_window=cfg.bins_per_window,
            dc=dc,
            calibration=cfg.calibration,
            calibrate=cfg.calibrate,
            history_windows=cfg.history_windows,
            power_model=cfg.power_model,
            device=str(self.device),
            slos=(NFR1,),
            pue=cfg.pue,
            sim_bins=self.t_bins if cfg.sim_in_state else 0,
        )
        sim_u = self._ensure_sim().u_th if cfg.sim_in_state else None
        self.state: TwinState = init_twin_state(self.twin_cfg, base_params,
                                                sim_u=sim_u)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def monitor(self) -> SLOMonitor:
        """SLO compliance view, hydrated from the core's accumulators."""
        return SLOMonitor.from_counts(
            self.twin_cfg.slos, self.state.slo_samples,
            self.state.slo_compliant)

    @property
    def bias(self) -> BiasTracker:
        """Fig.-6 bias split, hydrated from the core's accumulators."""
        return BiasTracker(under=int(self.state.bias_under),
                           over=int(self.state.bias_over),
                           ties=int(self.state.bias_ties))

    def save_state(self, path: str) -> None:
        """Checkpoint the twin core (:func:`repro_torch.core.state.save_state`)."""
        save_state(self.state, path)

    def restore_state(self, path: str) -> None:
        """Resume from a checkpoint, onto this orchestrator's device; the
        config must match this orchestrator's."""
        state = load_state(path, device=self.twin_cfg.device)
        if state.cfg != self.twin_cfg:
            raise ValueError(
                "checkpointed TwinConfig differs from this orchestrator's "
                f"configuration:\n  saved: {state.cfg}\n  here:  {self.twin_cfg}")
        self.state = state

    def _ensure_sim(self) -> SimOutput:
        """Full-horizon DES utilization field, computed once per topology
        and scheduler (``self.policy``, ``self.backfill_depth``)."""
        if self._sim is None:
            t0 = self.clock.now()
            self._sim = simulate_utilization(
                self.workload,
                num_hosts=self.dc.num_hosts,
                cores_per_host=self.dc.cores_per_host,
                t_bins=self.t_bins,
                policy=self.policy,
                backfill_depth=self.backfill_depth,
            )
            self._sync()
            self.des_seconds = self.clock.now() - t0
        return self._sim

    def invalidate(self) -> None:
        """Drop the cached DES output (topology or scheduler changed)."""
        self._sim = None

    @property
    def num_windows(self) -> int:
        return self.t_bins // self.cfg.bins_per_window

    def window_slice(self, window: int) -> slice:
        w = self.cfg.bins_per_window
        return slice(window * w, (window + 1) * w)

    def _trace_slice(self, trace, sl: slice):
        if trace is None:
            return None
        return torch.tensor(np.asarray(trace[sl], np.float32),
                            device=self.device)

    def run_window(self, window: int) -> WindowRecord:
        """Execute one window: gather its inputs, advance the core one
        ``twin_step``, then records, float64 bookkeeping, proposals, pacing."""
        t_start = self.clock.now()
        sim = self._ensure_sim()
        sl = self.window_slice(window)
        w_bins = sl.stop - sl.start

        tw = self.store.get(window)
        # telemetry measured on a different topology cannot score this twin
        if tw is not None and np.asarray(tw.u_th).shape[1] != self.dc.num_hosts:
            tw = None

        def measured(key, validate):
            v = tw.extras.get(key) if tw is not None else None
            if v is not None and np.asarray(v).shape[0] != w_bins:
                return None  # partially clipped extras: use the forecast
            return None if v is None else validate(np.asarray(v))

        ci_meas = measured(CARBON_INTENSITY_KEY, validate_carbon_intensity)
        pr_meas = measured(PRICE_KEY, validate_price)
        amb_meas = measured(AMBIENT_KEY, validate_ambient)

        # measured ambient feeds the prediction itself (PUE multiplies power)
        amb_w = (self._trace_slice(amb_meas, slice(None))
                 if amb_meas is not None
                 else self._trace_slice(self.ambient_c, sl))
        telem = (make_telemetry(tw.u_th, tw.power_w, device=self.device)
                 if tw is not None
                 else empty_telemetry(self.cfg.bins_per_window,
                                      self.dc.num_hosts, device=self.device))

        # in resident-DES mode the step slices its own window from
        # state.sim_u, the field apply_proposal last seeded
        t0 = self.clock.now()
        self.state, out = twin_step(
            self.state, telem, SimSlice(
                u_th=None if self.cfg.sim_in_state else sim.u_th[sl],
                carbon_intensity=self._trace_slice(self.carbon_intensity, sl),
                ambient_c=amb_w,
                price=self._trace_slice(self.price, sl)))
        pred = out.prediction
        self._sync()
        sim_seconds = self.clock.now() - t0

        rec = WindowRecord(
            window=window, started_at=t_start, sim_seconds=sim_seconds,
            params=out.params_used, prediction=pred)

        # float64 sustainability records: measured signals win over forecasts
        if ci_meas is not None:
            rec.gco2 = float(np.sum(_f64(pred.energy_kwh)
                                    * np.asarray(ci_meas, np.float64)))
        elif pred.gco2 is not None:
            rec.gco2 = float(np.sum(_f64(pred.gco2)))
        if pr_meas is not None:
            rec.energy_cost = float(np.sum(_f64(pred.energy_kwh)
                                           * np.asarray(pr_meas, np.float64)))
        elif pred.energy_cost is not None:
            rec.energy_cost = float(np.sum(_f64(pred.energy_cost)))

        if tw is not None:
            rec.mape = float(out.mape)
            props = propose_from_state(
                window,
                mape=rec.mape,
                mean_util=float(np.mean(tw.u_th)),
                queue_len=float(np.mean(sim.queue_len[sl].cpu().numpy())),
                power_w=float(np.mean(pred.power_w.cpu().numpy())),
                power_cap_w=self.cfg.power_cap_w,
            )
            for p_ in props:
                self.gate.submit(p_)
            rec.proposals = len(props)

        self.records.append(rec)

        if self.cfg.acceleration:
            wall = self.cfg.bins_per_window * SAMPLE_SECONDS / self.cfg.acceleration
            spent = self.clock.now() - t_start
            if wall > spent:
                self.clock.sleep(min(wall - spent, 1.0))  # capped for tests
        return rec

    def evaluate_whatif(
        self,
        scenarios: "list[Scenario] | tuple[Scenario, ...]",
        *,
        include_baseline: bool = True,
        max_hosts: int | None = None,
    ) -> WhatIfResult:
        """Evaluate S candidate configurations as one batch on the twin's
        device.

        Uses the *calibrated* power parameters, so outcomes reflect the
        live datacenter.  A baseline scenario (the current topology, worst
        fit, no backfill) always runs beside the candidates and every
        candidate is compared against it; each that improves a
        sustainability metric without breaking SLOs, cuts queue wait with
        another scheduler, or runs into its power cap becomes a proposal
        through the HITL gate.  ``include_baseline`` only decides whether
        the baseline appears in the returned summaries and outputs (as
        entry 0).  An explicit ``max_hosts`` is raised to at least the
        current host count, so the padded host axis fits the baseline.
        """
        scs = [self._with_pue(s)
               for s in [Scenario(name="baseline")] + list(scenarios)]
        if max_hosts is not None:
            max_hosts = max(int(max_hosts), self.dc.num_hosts)
        _, sim, pred, summaries = evaluate_scenarios(
            self.workload, self.dc, scs,
            t_bins=self.t_bins, base_params=self.state.params,
            max_hosts=max_hosts, model=self.cfg.power_model,
            carbon_intensity=self.carbon_intensity,
            ambient_c=self.ambient_c,
            price=self.price,
        )
        window = len(self.records)
        baseline = summaries[0]
        proposals: list[Proposal] = []
        for s in summaries[1:]:
            for p in propose_from_scenario(window, s, baseline):
                proposals.append(self.gate.submit(p))
        if not include_baseline:
            sim, pred = _drop_first_lane(sim), _drop_first_lane(pred)
            summaries = summaries[1:]
        return WhatIfResult(summaries=summaries, proposals=proposals,
                            sim=sim, prediction=pred)

    def apply_proposal(self, p: Proposal) -> None:
        """Apply an approved structural proposal to this twin (stage 3).

        ``SCHEDULER_CHANGE`` swaps the DES scheduler (placement policy and
        backfill depth); ``SCALE_UP`` / ``SCALE_DOWN_IDLE`` resize the
        topology.  The full-horizon DES then re-runs under the new
        configuration and the core is rebuilt around it
        (:meth:`_rebuild_state`); in resident-DES mode that re-seeds the
        state's own ``sim_u``.  Raises for an unapproved proposal and for
        kinds with no structural meaning here (caps and time shifts are
        scenario axes; recalibration is automatic).
        """
        if p.approved is not True:
            raise ValueError(
                f"proposal {p.kind.value}@w{p.window} is not approved — "
                "route it through the HITL gate before applying")
        if p.kind is ProposalKind.SCHEDULER_CHANGE:
            self.policy = p.impact.get("policy", self.policy)
            self.backfill_depth = int(
                p.impact.get("backfill_depth", self.backfill_depth))
        elif p.kind in (ProposalKind.SCALE_UP, ProposalKind.SCALE_DOWN_IDLE):
            if "num_hosts" not in p.impact:
                raise ValueError(
                    f"{p.kind.value} proposal carries no num_hosts impact")
            n = int(p.impact["num_hosts"])
            if n <= 0:
                raise ValueError(f"proposed num_hosts must be >= 1; got {n}")
            self.dc = dataclasses.replace(self.dc, num_hosts=n)
        else:
            raise ValueError(
                f"{p.kind.value} is not a structural proposal this twin can "
                "apply (power caps / load shifting are scenario axes; "
                "recalibration is automatic)")
        p.applied = True
        self.invalidate()
        self._rebuild_state()

    def _rebuild_state(self) -> None:
        """Rebuild the core around the current ``self.dc`` and scheduler.

        The run's accumulators (window, SLO counts, bias split) migrate.
        The calibrated parameters migrate and become the new base: per-host
        rows keep their first ``min(old, new)`` hosts and growth takes the
        rows' mean.  The calibration history migrates only while the host
        count is unchanged.  In resident-DES mode the new state is seeded
        with the re-run DES horizon.
        """
        old = self.state
        old_h = old.cfg.dc.num_hosts
        h = self.dc.num_hosts
        self.twin_cfg = dataclasses.replace(self.twin_cfg, dc=self.dc)
        sim_u = self._ensure_sim().u_th if self.cfg.sim_in_state else None

        def row(x):
            v = np.asarray(x.detach().cpu().numpy(), np.float32)
            if v.ndim == 0:
                return v
            out = np.full((h,), float(v.mean()), np.float32)
            out[:min(v.size, h)] = v[:h]
            return out

        params = PowerParams(p_idle=row(old.params.p_idle),
                             p_max=row(old.params.p_max),
                             r=row(old.params.r))
        state = init_twin_state(self.twin_cfg, params, sim_u=sim_u)
        keep = dict(window=old.window,
                    slo_samples=old.slo_samples,
                    slo_compliant=old.slo_compliant,
                    bias_under=old.bias_under,
                    bias_over=old.bias_over,
                    bias_ties=old.bias_ties)
        if h == old_h:
            keep.update(hist_u=old.hist_u, hist_p=old.hist_p,
                        hist_n=old.hist_n)
        self.state = dataclasses.replace(state, **keep)

    def default_search_space(self) -> SearchSpace:
        """A software-only search space for the current twin: the current
        topology under every placement policy (backfill 4 for all but
        worst fit), deferrable jobs shifted by up to 3 hours; cap axes off."""
        structures = tuple(
            Scenario(name=p, policy=p,
                     backfill_depth=0 if p == "worst_fit" else 4)
            for p in sorted(PLACEMENT_POLICIES))
        return SearchSpace(structures=structures, shift_bins=(0, 36))

    def optimize_whatif(
        self,
        space: SearchSpace | None = None,
        objective: ObjectiveSpec | None = None,
        *,
        key: "int | torch.Generator" = 0,
        config: OptimizerConfig = OptimizerConfig(),
        shard: bool = False,
        mesh=None,
    ) -> OptimizeWhatIfResult:
        """Search the scenario space and route the optimum through the gate.

        The space defaults to :meth:`default_search_space`; the search runs
        on the twin's device with its calibrated parameters
        (``self.state.params``) and forecasts.  Without a carbon forecast
        the default objective weights energy instead of gCO2.  The winner
        goes through :func:`~repro_torch.core.feedback.propose_from_optimum`
        against the baseline and its proposals are submitted to the gate.
        ``shard=True`` splits each batch over ``mesh``
        (:func:`~repro_torch.core.optimize.optimize`).
        """
        if space is None:
            space = self.default_search_space()
        if self.cfg.pue is not None:
            space = dataclasses.replace(
                space,
                structures=tuple(self._with_pue(s) for s in space.structures))
        if objective is None:
            objective = (ObjectiveSpec() if self.carbon_intensity is not None
                         else ObjectiveSpec(w_gco2_kg=0.0, w_energy_kwh=1.0))
        res = optimize(
            self.workload, self.dc, space, objective,
            t_bins=self.t_bins, base_params=self.state.params,
            carbon_intensity=self.carbon_intensity,
            ambient_c=self.ambient_c, price=self.price,
            key=key, config=config, model=self.cfg.power_model,
            shard=shard, mesh=mesh,
        )
        window = len(self.records)
        proposals = [
            self.gate.submit(p) for p in propose_from_optimum(
                window, res.best_summary, res.baseline_summary,
                objective=res.best.objective,
                baseline_objective=res.baseline.objective,
                breakdown=res.best.breakdown,
                baseline_breakdown=res.baseline.breakdown,
            )]
        return OptimizeWhatIfResult(result=res, proposals=proposals)

    def _with_pue(self, s: Scenario) -> Scenario:
        """Apply the orchestrator's facility PUE model to a scenario that
        sets none, so what-if comparisons stay facility against facility."""
        p = self.cfg.pue
        if p is None or s.pue_base is not None:
            return s
        return dataclasses.replace(
            s, pue_base=p.base, pue_amb_coeff=p.amb_coeff,
            pue_amb_ref=p.amb_ref, pue_load_coeff=p.load_coeff)

    def run(self, num_windows: int | None = None) -> list[WindowRecord]:
        n = num_windows if num_windows is not None else self.num_windows
        for w in range(n):
            self.run_window(w)
        return self.records

    def overall_mape(self) -> float:
        """MAPE over all scored bins (concatenated windows), in float32."""
        real, simp = [], []
        for rec in self.records:
            tw = self.store.get(rec.window)
            if tw is None:
                continue
            real.append(np.asarray(tw.power_w, np.float32))
            simp.append(rec.prediction.power_w.detach().cpu().numpy())
        if not real:
            return float("nan")
        return float(mape(torch.from_numpy(np.concatenate(real)),
                          torch.from_numpy(np.concatenate(simp))))

    def per_window_mape(self) -> np.ndarray:
        return np.array([r.mape if r.mape is not None else np.nan
                         for r in self.records])
