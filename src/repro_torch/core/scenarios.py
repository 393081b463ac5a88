"""Batched what-if scenario engine (paper Fig. 1, operator loop; port of
``repro.core.scenarios``).

What-if analysis re-simulates the same trace against S candidate
configurations (topologies, placement policies, power-model parameters,
enforced static and carbon-aware power caps, workload perturbations and
deferrable-job time shifts, host failures, dynamic PUE, spot prices) and
compares SLO and sustainability outcomes before any hardware moves.  The
S candidates are lanes of one batch: the DES places every lane in one
launch of the placement kernel (:func:`repro_torch.kernels.ops.des_place`)
and the readout covers every lane, in one launch of the fused readout
kernel with ``fused_readout=True`` (the JAX package's ``use_pallas``).

Pipeline::

    [Scenario, ...]  --build_scenario_set-->  ScenarioSet (leaves [S, ...])
    ScenarioSet      --run_scenarios------->  SimOutput + Prediction ([S, ...])
    ScenarioSet      --evaluate_scenarios-->  [ScenarioSummary] (host-side)

``Orchestrator.evaluate_whatif`` routes the summaries through the HITL
gate as proposals (``feedback.propose_from_scenario``).  With
``shard=True`` the S lanes split over a device mesh
(:func:`scenario_mesh`), one placement and one readout launch an entry.
The JAX package's buffer donation (``donate``) is not taken.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.desim import (
    _BATCH_READOUT_THRESHOLD,
    POLICY_NAMES,
    Prediction,
    SimOutput,
    resolve_policy,
    _place_masked,
    _read_out_placed,
)
from repro_torch.core.power import (
    PowerParams,
    carbon_gco2,
    datacenter_power,
    energy_kwh,
    validate_power_params,
)
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (
    Mesh,
    gather_lanes,
    lane_devices,
    lane_mesh,
    lane_padding,
    shard_lanes,
)
from repro_torch.runtime.fault import NEVER_BIN, failure_arrays
from repro_torch.traces.carbon import validate_carbon_intensity
from repro_torch.traces.price import validate_price
from repro_torch.traces.schema import (
    SAMPLE_SECONDS,
    DatacenterConfig,
    Workload,
    host_mask,
)
from repro_torch.traces.thermal import validate_ambient

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One what-if candidate.  ``None`` fields inherit the base config.

    Axes: topology (``num_hosts``, ``cores_per_host``); scheduler
    (``policy``, a name of ``desim.PLACEMENT_POLICIES`` or ``None`` for
    worst fit, and ``backfill_depth`` in [0, 31]); power model (``p_idle``,
    ``p_max``, ``r`` overrides); power caps (``power_cap_w``, enforced, and
    the carbon-aware ``carbon_cap_base_w + carbon_cap_slope * intensity_t``;
    the effective per-bin cap is the minimum of the two, and a carbon-aware
    cap needs a carbon-intensity trace at run time); workload
    (``arrival_scale``, ``duration_scale``, ``util_scale`` and
    ``shift_bins`` of deferrable jobs); failures (a tuple of
    :class:`repro_torch.runtime.fault.HostFailure`, one window per host,
    starting inside the horizon); dynamic PUE (``pue_base >= 1`` switches
    it on; coefficients without it are rejected).  Invalid values raise at
    construction, with the JAX package's messages.
    """

    name: str = ""
    num_hosts: int | None = None
    cores_per_host: int | None = None
    policy: str | int | None = None
    backfill_depth: int = 0
    p_idle: float | None = None
    p_max: float | None = None
    r: float | None = None
    power_cap_w: float | None = None
    carbon_cap_base_w: float | None = None
    carbon_cap_slope: float = 0.0
    arrival_scale: float = 1.0
    duration_scale: float = 1.0
    util_scale: float = 1.0
    shift_bins: int = 0
    failures: tuple = ()
    pue_base: float | None = None
    pue_amb_coeff: float = 0.0
    pue_amb_ref: float = 18.0
    pue_load_coeff: float = 0.0

    def __post_init__(self):
        if self.r is not None and not (math.isfinite(self.r) and self.r > 0):
            raise ValueError(
                f"scenario {self.name!r}: power-model exponent r must be "
                f"> 0, got {self.r}")
        if self.p_idle is not None and not (math.isfinite(self.p_idle)
                                            and self.p_idle >= 0):
            raise ValueError(
                f"scenario {self.name!r}: p_idle must be finite and >= 0 W, "
                f"got {self.p_idle}")
        if self.p_max is not None and not math.isfinite(self.p_max):
            raise ValueError(
                f"scenario {self.name!r}: p_max must be finite W, "
                f"got {self.p_max}")
        if (self.p_idle is not None and self.p_max is not None
                and self.p_max < self.p_idle):
            raise ValueError(
                f"scenario {self.name!r}: p_max ({self.p_max}) < p_idle "
                f"({self.p_idle}) inverts the power curve")
        if self.power_cap_w is not None and not self.power_cap_w > 0:
            raise ValueError(
                f"scenario {self.name!r}: power_cap_w must be > 0 W, "
                f"got {self.power_cap_w}")
        if self.carbon_cap_base_w is not None and not self.carbon_cap_base_w > 0:
            raise ValueError(
                f"scenario {self.name!r}: carbon_cap_base_w must be > 0 W, "
                f"got {self.carbon_cap_base_w}")
        if not math.isfinite(self.carbon_cap_slope):
            raise ValueError(
                f"scenario {self.name!r}: carbon_cap_slope must be finite "
                f"W per gCO2/kWh, got {self.carbon_cap_slope}")
        if not 0 <= int(self.backfill_depth) <= 31:
            raise ValueError(
                f"scenario {self.name!r}: backfill_depth must be in [0, 31] "
                f"(uint32 skip-mask width), got {self.backfill_depth}")
        for knob in ("arrival_scale", "duration_scale"):
            if not getattr(self, knob) > 0:
                raise ValueError(
                    f"scenario {self.name!r}: {knob} must be > 0, "
                    f"got {getattr(self, knob)}")
        if not self.util_scale >= 0:
            raise ValueError(
                f"scenario {self.name!r}: util_scale must be >= 0, "
                f"got {self.util_scale}")
        if not isinstance(self.failures, tuple):
            object.__setattr__(self, "failures", tuple(self.failures))
        for f in self.failures:
            for attr in ("host", "start_bin", "end_bin", "kind"):
                if not hasattr(f, attr):
                    raise ValueError(
                        f"scenario {self.name!r}: failures must be "
                        f"HostFailure windows, got {f!r}")
        if self.pue_base is not None and not (
                math.isfinite(self.pue_base) and self.pue_base >= 1.0):
            raise ValueError(
                f"scenario {self.name!r}: pue_base must be finite and >= 1 "
                f"(facility/IT power ratio), got {self.pue_base}")
        for knob in ("pue_amb_coeff", "pue_load_coeff"):
            v = getattr(self, knob)
            if not (math.isfinite(v) and v >= 0):
                raise ValueError(
                    f"scenario {self.name!r}: {knob} must be finite and "
                    f">= 0, got {v}")
        if not math.isfinite(self.pue_amb_ref):
            raise ValueError(
                f"scenario {self.name!r}: pue_amb_ref must be finite °C, "
                f"got {self.pue_amb_ref}")
        if self.pue_base is None and (self.pue_amb_coeff != 0.0
                                      or self.pue_load_coeff != 0.0):
            raise ValueError(
                f"scenario {self.name!r}: PUE coefficients set without "
                "pue_base — set pue_base (>= 1) to enable the dynamic-PUE "
                "axis")


@dataclasses.dataclass(frozen=True)
class ScenarioSet:
    """Device-ready stacked scenario batch (every tensor leads with S).

    ``workload`` leaves ``[S, J, ...]`` (per-scenario perturbed copies of
    one trace), ``host_mask_s [S, H]`` bool, ``num_hosts``,
    ``cores_per_host``, ``policy_id``, ``backfill_depth`` and
    ``shift_bins`` ``[S]`` int32, ``params`` leaves ``[S, H]`` float32
    (per-host rows), ``power_cap_w``/``carbon_cap_base_w`` ``[S]`` float32
    (``+inf``: no cap), ``carbon_cap_slope``, ``peak_tflops`` and the four
    PUE parameters ``[S]`` float32 (PUE 1.0 and zero coefficients: the
    identity), ``fail_start``/``fail_end`` ``[S, H]`` int32 (start
    ``int32.max``: never fails) and ``fail_kill [S, H]`` bool, all on the
    workload's device.  ``names``, ``max_backfill`` (the backfill window
    every depth is clipped to), ``has_failures`` and ``pue_on`` (whether
    the failure and PUE machinery runs at all) are plain Python values.
    """

    workload: Workload
    host_mask_s: Tensor
    num_hosts: Tensor
    cores_per_host: Tensor
    policy_id: Tensor
    backfill_depth: Tensor
    params: PowerParams
    power_cap_w: Tensor
    carbon_cap_base_w: Tensor
    carbon_cap_slope: Tensor
    shift_bins: Tensor
    peak_tflops: Tensor
    fail_start: Tensor
    fail_end: Tensor
    fail_kill: Tensor
    pue_base: Tensor
    pue_amb_coeff: Tensor
    pue_amb_ref: Tensor
    pue_load_coeff: Tensor
    names: tuple[str, ...]
    max_backfill: int = 0
    has_failures: bool = False
    pue_on: bool = False

    @property
    def num_scenarios(self) -> int:
        return len(self.names)

    @property
    def max_hosts(self) -> int:
        return int(self.host_mask_s.shape[-1])


def _host(x) -> np.ndarray:
    """``x`` (a number, array or tensor on any device) as a numpy array."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _perturb(base: dict[str, np.ndarray | None],
             sc: Scenario) -> dict[str, np.ndarray | None]:
    """Apply a scenario's workload knobs (host-side numpy).

    ``base`` holds the job-axis arrays (``submit``, ``dur``, ``util``,
    ``cores``, ``valid``, ``deferrable``, the last possibly ``None``).
    Time-shifting moves deferrable valid jobs by ``sc.shift_bins`` bins
    (clipped at 0) and re-sorts the job axis stably by submission time: the
    DES's FCFS order is the array order.
    """
    out = dict(base)
    submit, dur, util = base["submit"], base["dur"], base["util"]
    if sc.arrival_scale != 1.0:
        submit = np.floor(
            submit.astype(np.float32) / sc.arrival_scale).astype(np.int32)
    if sc.duration_scale != 1.0:
        dur = np.maximum(
            np.ceil(dur.astype(np.float32) * sc.duration_scale), 1.0
        ).astype(np.int32)
    if sc.util_scale != 1.0:
        util = np.clip(util * sc.util_scale, 0.0, 1.0).astype(np.float32)
    out.update(submit=submit, dur=dur, util=util)
    if sc.shift_bins != 0:
        defer = base["deferrable"]
        movable = (base["valid"] if defer is None
                   else (defer & base["valid"]))
        submit = np.where(
            movable, np.maximum(submit + int(sc.shift_bins), 0), submit
        ).astype(np.int32)
        order = np.argsort(submit, kind="stable")
        out.update(
            submit=submit[order], dur=out["dur"][order],
            util=out["util"][order], cores=base["cores"][order],
            valid=base["valid"][order],
            deferrable=None if defer is None else defer[order],
        )
    return out


def _per_host_params(base_params: PowerParams, scenarios, mh: int,
                     device) -> PowerParams:
    """Power params as ``[S, max_hosts]`` rows (per-host aware).

    The base may be scalars or per-host vectors; a scenario override is a
    scalar and replaces the whole row; hosts beyond the base vector's
    length take the fleet mean.  The rows are validated elementwise on the
    host before they move to ``device``.
    """
    def rows(field: str) -> np.ndarray:
        base_v = np.asarray(_host(getattr(base_params, field)),
                            np.float32).reshape(-1)
        base_row = np.full((mh,), float(base_v.mean()), np.float32)
        base_row[:min(base_v.size, mh)] = base_v[:mh]
        out = np.empty((len(scenarios), mh), np.float32)
        for i, sc in enumerate(scenarios):
            ov = getattr(sc, field)
            out[i] = base_row if ov is None else np.float32(ov)
        return out

    p_idle, p_max, r = rows("p_idle"), rows("p_max"), rows("r")
    validate_power_params(p_idle, p_max, r)
    return PowerParams(*(torch.as_tensor(x, device=device)
                         for x in (p_idle, p_max, r)))


def build_scenario_set(
    workload: Workload,
    dc: DatacenterConfig,
    scenarios: "list[Scenario] | tuple[Scenario, ...]",
    base_params: PowerParams = PowerParams(),
    max_hosts: int | None = None,
    max_backfill: int | None = None,
    has_failures: bool | None = None,
    pue_on: bool | None = None,
) -> ScenarioSet:
    """Stack S candidate configurations against one base trace/topology.

    Host-side (numpy) assembly on the workload's device: each scenario's
    knobs are resolved against ``dc``/``base_params``, workload
    perturbations are applied to copies of the trace, and everything is
    stacked with the scenario axis first.  The host axis is padded to
    ``max_hosts`` (default: the largest candidate); ``max_backfill``
    defaults to the largest depth; ``has_failures``/``pue_on`` default to
    "some scenario uses the axis", and forcing one off while a scenario
    uses it is rejected.

    Raises ``ValueError`` on an empty list, a candidate wanting more hosts
    than ``max_hosts``, a depth beyond ``max_backfill``, or a failure
    window on a host the scenario's topology does not have.
    """
    if not scenarios:
        raise ValueError("need at least one scenario")
    dev = workload.device
    hosts = [sc.num_hosts if sc.num_hosts is not None else dc.num_hosts
             for sc in scenarios]
    mh = max(hosts) if max_hosts is None else int(max_hosts)
    if max(hosts) > mh:
        raise ValueError(f"scenario wants {max(hosts)} hosts > max_hosts={mh}")

    cores = [sc.cores_per_host if sc.cores_per_host is not None
             else dc.cores_per_host for sc in scenarios]
    names = tuple(sc.name or f"s{i}" for i, sc in enumerate(scenarios))

    base = dict(
        submit=_host(workload.submit_bin),
        dur=_host(workload.duration_bins),
        util=_host(workload.util_levels),
        cores=_host(workload.cores),
        valid=_host(workload.valid),
        deferrable=(None if workload.deferrable is None
                    else _host(workload.deferrable)),
    )
    perturbed = [_perturb(base, sc) for sc in scenarios]

    def stack(key, dtype=None):
        return torch.as_tensor(np.stack([p[key] for p in perturbed]),
                               dtype=dtype, device=dev)

    wl = Workload(
        submit_bin=stack("submit", torch.int32),
        duration_bins=stack("dur", torch.int32),
        cores=stack("cores", torch.int32),
        util_levels=stack("util", torch.float32),
        valid=stack("valid", torch.bool),
        deferrable=None if base["deferrable"] is None else stack("deferrable",
                                                                 torch.bool),
    )

    depths = [int(sc.backfill_depth) for sc in scenarios]
    mb = max(depths) if max_backfill is None else int(max_backfill)
    if not 0 <= mb <= 31:
        raise ValueError(
            f"max_backfill must be in [0, 31] (uint32 skip-mask width), "
            f"got {mb}")
    if max(depths) > mb:
        raise ValueError(
            f"scenario wants backfill_depth {max(depths)} > "
            f"max_backfill={mb}")

    def lane(values, dtype):
        return torch.as_tensor(values, dtype=dtype, device=dev)

    peak = [dataclasses.replace(dc, num_hosts=h, cores_per_host=c).peak_tflops
            for h, c in zip(hosts, cores)]
    cap = [sc.power_cap_w if sc.power_cap_w is not None else math.inf
           for sc in scenarios]
    carbon_base = [sc.carbon_cap_base_w if sc.carbon_cap_base_w is not None
                   else math.inf for sc in scenarios]

    any_fail = any(sc.failures for sc in scenarios)
    if has_failures is None:
        has_failures = any_fail
    elif any_fail and not has_failures:
        raise ValueError(
            "has_failures=False but scenario(s) carry failure windows")
    fs_rows, fe_rows, fk_rows = [], [], []
    for sc, h in zip(scenarios, hosts):
        for f in sc.failures:
            if f.host >= h:
                raise ValueError(
                    f"scenario {sc.name!r}: failure host {f.host} out of "
                    f"range for its {h}-host topology")
        fs, fe, fk = failure_arrays(sc.failures, mh)
        fs_rows.append(fs)
        fe_rows.append(fe)
        fk_rows.append(fk)

    any_pue = any(sc.pue_base is not None for sc in scenarios)
    if pue_on is None:
        pue_on = any_pue
    elif any_pue and not pue_on:
        raise ValueError("pue_on=False but scenario(s) set pue_base")

    f32, i32 = torch.float32, torch.int32
    hosts_a = lane(hosts, i32)
    return ScenarioSet(
        workload=wl,
        host_mask_s=host_mask(hosts_a, mh),
        num_hosts=hosts_a,
        cores_per_host=lane(cores, i32),
        policy_id=lane([resolve_policy(sc.policy) for sc in scenarios], i32),
        backfill_depth=lane(depths, i32),
        params=_per_host_params(base_params, scenarios, mh, dev),
        power_cap_w=lane(cap, f32),
        carbon_cap_base_w=lane(carbon_base, f32),
        carbon_cap_slope=lane([sc.carbon_cap_slope for sc in scenarios], f32),
        shift_bins=lane([int(sc.shift_bins) for sc in scenarios], i32),
        peak_tflops=lane(peak, f32),
        fail_start=lane(np.stack(fs_rows), i32),
        fail_end=lane(np.stack(fe_rows), i32),
        fail_kill=lane(np.stack(fk_rows), torch.bool),
        pue_base=lane([1.0 if sc.pue_base is None else sc.pue_base
                       for sc in scenarios], f32),
        pue_amb_coeff=lane([sc.pue_amb_coeff for sc in scenarios], f32),
        pue_amb_ref=lane([sc.pue_amb_ref for sc in scenarios], f32),
        pue_load_coeff=lane([sc.pue_load_coeff for sc in scenarios], f32),
        names=names,
        max_backfill=mb,
        has_failures=bool(has_failures),
        pue_on=bool(pue_on),
    )


def _predict_masked(u_th: Tensor, params: PowerParams, mask: Tensor,
                    peak_tflops: Tensor, model: str, cap_t: Tensor,
                    intensity: Tensor | None, *,
                    online_th: Tensor | None = None,
                    pue: tuple[Tensor, Tensor, Tensor, Tensor] | None = None,
                    ambient: Tensor | None = None,
                    price: Tensor | None = None) -> Prediction:
    """Mask-aware prediction of every lane, unfused (the JAX package's
    default readout).

    ``u_th [S, T, H]``, host rows ``[S, H]`` (``params`` leaves, ``mask``),
    ``peak_tflops [S]``, the effective cap ``cap_t [S, T]`` (``+inf``:
    uncapped), shared ``[T]`` traces.  Padded hosts draw nothing and do not
    dilute utilization.  ``online_th [S, T, H]`` takes hosts in an outage
    out of power and utilization; ``pue`` (base, ambient coefficient,
    ambient reference, load coefficient, each ``[S]``) makes power facility
    watts, PUE from the unthrottled mean utilization.  The cap clips
    delivered power and throttles performance linearly in the above-idle
    draw; ``power_demand_w`` keeps the pre-cap demand.
    """
    rows = PowerParams(*(x[:, None, :] for x in (params.p_idle, params.p_max,
                                                   params.r)))
    maskf = mask.to(u_th.dtype)[:, None, :]                        # [S, 1, H]
    onf = maskf if online_th is None else online_th.to(u_th.dtype) * maskf
    it_demand = datacenter_power(u_th, rows, model=model, online_mask=onf)
    idle_floor = (rows.p_idle * onf).sum(dim=-1)                   # [S, T] or [S, 1]
    util_raw = (u_th * onf).sum(dim=-1) / onf.sum(dim=-1).clamp(min=1.0)
    pue_t = None
    demand = it_demand
    if pue is not None:
        base, amb_coeff, amb_ref, load_coeff = (x[:, None] for x in pue)
        pue_t = base + load_coeff * (1.0 - util_raw.clamp(0.0, 1.0))
        if ambient is not None:
            pue_t = pue_t + amb_coeff * (ambient - amb_ref).clamp(min=0.0)
        demand = it_demand * pue_t
        idle_floor = idle_floor * pue_t
    exceeded = demand > cap_t
    power = torch.minimum(demand, cap_t)
    throttle = ((cap_t - idle_floor)
                / (demand - idle_floor).clamp(min=1e-9)).clamp(0.0, 1.0)
    e = energy_kwh(power, SAMPLE_SECONDS)
    util = torch.where(exceeded, util_raw * throttle, util_raw)
    tflops = util * peak_tflops[:, None]
    eff = tflops / e.clamp(min=1e-9)
    gco2 = None if intensity is None else carbon_gco2(e, intensity)
    cost = None if price is None else e * price
    return Prediction(power_w=power, energy_kwh=e, tflops=tflops,
                      utilization=util, efficiency=eff, gco2=gco2,
                      power_demand_w=demand, pue=pue_t, energy_cost=cost)


def _failure_kw(ss: ScenarioSet) -> dict:
    return (dict(fail_start=ss.fail_start, fail_end=ss.fail_end,
                 fail_kill=ss.fail_kill) if ss.has_failures else {})


def _scenario_place(ss: ScenarioSet, *, max_hosts: int, t_bins: int,
                    max_starts_per_bin: int) -> tuple:
    """Every lane's placement, one launch, no read on the host."""
    return _place_masked(
        ss.workload, ss.host_mask_s, ss.cores_per_host, max_hosts=max_hosts,
        t_bins=t_bins, max_starts_per_bin=max_starts_per_bin,
        policy_id=ss.policy_id, backfill_depth=ss.backfill_depth,
        max_backfill=ss.max_backfill, **_failure_kw(ss))


def _scenario_lanes(ss: ScenarioSet, carbon_intensity: Tensor | None,
                    ambient_c: Tensor | None, price: Tensor | None, *,
                    max_hosts: int, t_bins: int, max_starts_per_bin: int,
                    model: str, chunk: bool, fused_readout: bool,
                    precision: str, placed: "tuple | None" = None
                    ) -> tuple[SimOutput, Prediction]:
    """The DES of every lane (one placement launch, or ``placed``, its
    result from :func:`_scenario_place`), then the readout of every lane:
    fused (one readout launch) or unfused."""
    fail = _failure_kw(ss)
    if placed is None:
        placed = _scenario_place(ss, max_hosts=max_hosts, t_bins=t_bins,
                                 max_starts_per_bin=max_starts_per_bin)
    sim = _read_out_placed(placed, max_hosts=max_hosts, t_bins=t_bins,
                           force_chunked_readout=chunk)
    # effective per-bin cap: min(static cap, carbon-aware cap)
    cap_t = ss.power_cap_w[:, None].expand(-1, t_bins)
    if carbon_intensity is not None:
        cap_t = torch.minimum(cap_t, (ss.carbon_cap_base_w[:, None]
                                      + ss.carbon_cap_slope[:, None]
                                      * carbon_intensity).clamp(min=0.0))
    if fused_readout:
        rd = ops.des_readout(
            sim.u_th, p_idle=ss.params.p_idle, p_max=ss.params.p_max,
            r=ss.params.r, mask=ss.host_mask_s, cap_t=cap_t,
            intensity=carbon_intensity, ambient=ambient_c, price=price,
            peak_tflops=ss.peak_tflops, pue_base=ss.pue_base,
            pue_amb_coeff=ss.pue_amb_coeff, pue_amb_ref=ss.pue_amb_ref,
            pue_load_coeff=ss.pue_load_coeff, model=model,
            precision=precision, dt_seconds=SAMPLE_SECONDS, **fail)
        pred = Prediction(
            power_w=rd["power_w"], energy_kwh=rd["energy_kwh"],
            tflops=rd["tflops"], utilization=rd["utilization"],
            efficiency=rd["efficiency"],
            gco2=None if carbon_intensity is None else rd["gco2"],
            power_demand_w=rd["power_demand_w"],
            pue=rd["pue"] if ss.pue_on else None,
            energy_cost=None if price is None else rd["energy_cost"])
        return sim, pred
    online_th = None
    if ss.has_failures:
        # power-side availability: only outage hosts stop drawing power
        tt = torch.arange(t_bins, dtype=torch.int32, device=sim.u_th.device)[:, None]
        offline = (ss.fail_kill[:, None, :] & (tt >= ss.fail_start[:, None, :])
                   & (tt < ss.fail_end[:, None, :]))                # [S, T, H]
        online_th = ss.host_mask_s[:, None, :] & ~offline
    pue = ((ss.pue_base, ss.pue_amb_coeff, ss.pue_amb_ref, ss.pue_load_coeff)
           if ss.pue_on else None)
    pred = _predict_masked(sim.u_th, ss.params, ss.host_mask_s, ss.peak_tflops,
                           model, cap_t, carbon_intensity, online_th=online_th,
                           pue=pue, ambient=ambient_c, price=price)
    return sim, pred


def run_scenarios(
    ss: ScenarioSet,
    *,
    max_hosts: int,
    t_bins: int,
    max_starts_per_bin: int = 64,
    model: str = "opendc",
    carbon_intensity=None,
    ambient_c=None,
    price=None,
    fused_readout: bool = False,
    readout_precision: str = "f32",
    shard: bool = False,
    mesh: "Mesh | None" = None,
) -> tuple[SimOutput, Prediction]:
    """Simulate and predict all S scenarios as one batch.

    Returns a batched :class:`SimOutput` and :class:`Prediction`:
    ``sim.u_th`` ``[S, t_bins, max_hosts]`` (padded hosts read 0),
    ``job_start``/``job_host`` ``[S, J]`` (-1: never started), every
    prediction leaf ``[S, t_bins]``.

    ``carbon_intensity`` (``[t_bins]`` gCO2/kWh) fills ``gco2`` and makes
    carbon-aware caps computable; a carbon-aware cap without it is
    rejected.  ``ambient_c`` (``[t_bins]`` °C) feeds the dynamic PUE, and
    lanes with a nonzero ``pue_amb_coeff`` require it.  ``price``
    (``[t_bins]`` $/kWh) fills ``energy_cost``.  A failure window must
    start inside the horizon.

    ``fused_readout`` stands for the JAX package's ``use_pallas`` (same
    default, off): with it the readout of every lane is one launch of the
    fused readout (:func:`repro_torch.kernels.ops.des_readout`) with
    per-lane host rows, caps ``[S, T]``, PUE scalars ``[S]`` and failure
    windows, within the oracle's tolerance of the unfused readout but not
    bitwise; ``readout_precision`` is its ``precision`` (``"bf16"``
    rounds the performance leaves).  Without it the unfused readout runs,
    which the JAX package's goldens pin.

    **Scenario-axis sharding** (``shard=True``): the S axis splits over
    the entries of ``mesh`` (default: :func:`scenario_mesh` over every
    device of the set's kind).  S pads to a multiple of the entries with
    replicas of scenario 0 named ``""`` (at least 2 lanes an entry when
    there is more than one), entry ``k`` runs its contiguous shard on its
    device with the traces whole, one ``des_place`` (and, fused, one
    ``des_readout``) launch an entry, every entry's placement queued
    before the first read on the host, and the outputs come back in lane
    order on the set's device, cut to S: equal bit for bit to the
    unsharded batch.  The readout's time chunking is decided from the
    whole, unpadded S, as the unsharded batch decides it.  A ``mesh``
    without ``shard=True`` raises.
    """
    dev = ss.host_mask_s.device

    def trace(x, validate):
        return torch.as_tensor(validate(_host(x), t_bins), device=dev)

    if carbon_intensity is None:
        if np.isfinite(_host(ss.carbon_cap_base_w)).any():
            raise ValueError(
                "scenario(s) set carbon_cap_base_w but no carbon_intensity "
                "trace was supplied — a carbon-aware cap cannot be computed "
                "without one (pass carbon_intensity=[t_bins] gCO2/kWh)")
        ci = None
    else:
        ci = trace(carbon_intensity, validate_carbon_intensity)
    if ss.has_failures:
        fs = _host(ss.fail_start)
        bad = (fs < NEVER_BIN) & (fs >= t_bins)
        if bad.any():
            s_bad, h_bad = map(int, np.argwhere(bad)[0])
            raise ValueError(
                f"scenario {s_bad} host {h_bad}: failure window starts at "
                f"bin {int(fs[s_bad, h_bad])}, at/past the {t_bins}-bin "
                "horizon — it can never fire")
    if ambient_c is None:
        if ss.pue_on and _host(ss.pue_amb_coeff).any():
            raise ValueError(
                "scenario(s) set pue_amb_coeff but no ambient_c trace was "
                "supplied — the ambient-driven PUE term cannot be computed "
                "without one (pass ambient_c=[t_bins] °C)")
        amb = None
    else:
        amb = trace(ambient_c, validate_ambient)
    pr = None if price is None else trace(price, validate_price)
    s = ss.num_scenarios
    n_jobs = int(ss.workload.submit_bin.shape[-1])
    kw = dict(max_hosts=max_hosts, t_bins=t_bins,
              max_starts_per_bin=max_starts_per_bin)
    lane_kw = dict(kw, model=model, fused_readout=fused_readout,
                   precision=readout_precision,
                   chunk=s * n_jobs * t_bins > _BATCH_READOUT_THRESHOLD)
    if not shard:
        if mesh is not None:
            raise ValueError("mesh given but shard=False")
        return _scenario_lanes(ss, ci, amb, pr, **lane_kw)
    devices = lane_devices(scenario_mesh(device=dev.type) if mesh is None
                           else mesh, SCENARIO_AXIS)
    per, pad = lane_padding(s, len(devices))
    names = ss.names + ("",) * pad
    shards = [dataclasses.replace(x, names=names[k * per:(k + 1) * per])
              for k, x in enumerate(shard_lanes(ss, devices, s, 0, "scenario set"))]
    placed = [_scenario_place(x, **kw) for x in shards]
    results = [
        _scenario_lanes(x, *(None if t is None else t.to(d) for t in (ci, amb, pr)),
                        placed=p, **lane_kw)
        for x, d, p in zip(shards, devices, placed)]
    return gather_lanes(results, s, 0, dev)


#: mesh axis name the scenario (lane) axis is sharded over
SCENARIO_AXIS = "scenarios"


def scenario_mesh(num_devices: "int | None" = None, *,
                  device: "str | torch.device" = "cuda") -> Mesh:
    """A 1-D mesh over :data:`SCENARIO_AXIS`: every card by default (the
    first ``num_devices`` otherwise, more than the host has raising), or
    ``num_devices`` CPU entries (default 1) with ``device="cpu"``."""
    return lane_mesh(SCENARIO_AXIS, num_devices, device)


@dataclasses.dataclass(frozen=True)
class ScenarioSummary:
    """Host-side per-scenario read-out an operator (or the HITL gate)
    compares: the scheduler that ran, queue and wait statistics (waits in
    bins over started jobs, NaN if none started), unplaced jobs, delivered
    (post-cap) energy and power, peak demand, CPU-hours, carbon (NaN
    without a trace), cap provenance and cap-limited bins, mean PUE and
    energy cost (``None`` when the axis is off), failure windows."""

    name: str
    num_hosts: int
    cores_per_host: int
    policy: str
    backfill_depth: int
    mean_util: float
    p99_queue: float
    max_queue: int
    mean_wait_bins: float
    p99_wait_bins: float
    unplaced_jobs: int
    total_jobs: int
    energy_kwh: float
    mean_power_w: float
    peak_power_w: float
    peak_demand_w: float
    cpu_hours: float
    kwh_per_cpu_hour: float
    gco2: float
    carbon_intensity_avg: float
    shift_bins: int
    power_cap_w: float | None
    carbon_cap_base_w: float | None
    carbon_cap_slope: float
    cap_exceeded_bins: int
    mean_pue: float | None = None
    energy_cost: float | None = None
    failure_events: int = 0


def summarize_scenarios(
    ss: ScenarioSet, sim: SimOutput, pred: Prediction,
    carbon_intensity=None,
) -> list[ScenarioSummary]:
    """Collapse batched outputs into one comparable record per scenario.

    Pass the ``carbon_intensity`` the sweep ran with so cap-limited bins
    are counted against the effective (carbon-aware) per-bin cap.
    """
    util = _host(pred.utilization)
    queue = _host(sim.queue_len)
    start = _host(sim.job_start)
    submit = _host(ss.workload.submit_bin)
    valid = _host(ss.workload.valid)
    power = _host(pred.power_w)
    demand = (_host(pred.power_demand_w) if pred.power_demand_w is not None
              else power)
    energy = _host(pred.energy_kwh)
    gco2 = _host(pred.gco2) if pred.gco2 is not None else None
    cap = _host(ss.power_cap_w)
    cbase = _host(ss.carbon_cap_base_w)
    cslope = _host(ss.carbon_cap_slope)
    shifts = _host(ss.shift_bins)
    policy = _host(ss.policy_id)
    depth = _host(ss.backfill_depth)
    hosts = _host(ss.num_hosts)
    cores = _host(ss.cores_per_host)
    pue = _host(pred.pue) if pred.pue is not None else None
    cost = (_host(pred.energy_cost).astype(np.float64)
            if pred.energy_cost is not None else None)
    fail_ct = (_host(ss.fail_start) < NEVER_BIN).sum(axis=-1)
    ci = (None if carbon_intensity is None
          else np.asarray(_host(carbon_intensity), np.float64))
    cpu_h = _host(ss.workload.cpu_hours().sum(dim=-1))

    out = []
    for s, name in enumerate(ss.names):
        ch = float(cpu_h[s])
        ekwh = float(energy[s].sum())
        placed = (start[s] >= 0) & valid[s]
        waits = (start[s] - submit[s])[placed]
        cap_t = np.full_like(power[s], cap[s])
        if ci is not None:
            cap_t = np.minimum(
                cap_t, np.maximum(cbase[s] + cslope[s] * ci, 0.0))
        g = float(gco2[s].sum()) if gco2 is not None else float("nan")
        out.append(ScenarioSummary(
            name=name,
            num_hosts=int(hosts[s]),
            cores_per_host=int(cores[s]),
            policy=POLICY_NAMES[int(policy[s])],
            backfill_depth=int(depth[s]),
            mean_wait_bins=(float(waits.mean()) if waits.size
                            else float("nan")),
            p99_wait_bins=(float(np.percentile(waits, 99)) if waits.size
                           else float("nan")),
            mean_util=float(util[s].mean()),
            p99_queue=float(np.percentile(queue[s], 99)),
            max_queue=int(queue[s].max()),
            unplaced_jobs=int(((start[s] < 0) & valid[s]).sum()),
            total_jobs=int(valid[s].sum()),
            energy_kwh=ekwh,
            mean_power_w=float(power[s].mean()),
            peak_power_w=float(power[s].max()),
            peak_demand_w=float(demand[s].max()),
            cpu_hours=ch,
            kwh_per_cpu_hour=(ekwh / ch) if ch > 0 else float("nan"),
            gco2=g,
            carbon_intensity_avg=(g / ekwh if np.isfinite(g) and ekwh > 0
                                  else float("nan")),
            shift_bins=int(shifts[s]),
            power_cap_w=None if np.isinf(cap[s]) else float(cap[s]),
            carbon_cap_base_w=(None if np.isinf(cbase[s])
                               else float(cbase[s])),
            carbon_cap_slope=float(cslope[s]),
            cap_exceeded_bins=int((demand[s] > cap_t).sum()),
            mean_pue=(float(pue[s].mean()) if pue is not None else None),
            energy_cost=(float(cost[s].sum()) if cost is not None else None),
            failure_events=int(fail_ct[s]),
        ))
    return out


def evaluate_scenarios(
    workload: Workload,
    dc: DatacenterConfig,
    scenarios: "list[Scenario] | tuple[Scenario, ...]",
    *,
    t_bins: int,
    base_params: PowerParams = PowerParams(),
    max_hosts: int | None = None,
    model: str = "opendc",
    max_starts_per_bin: int = 64,
    carbon_intensity=None,
    ambient_c=None,
    price=None,
    fused_readout: bool = False,
    shard: bool = False,
    mesh: "Mesh | None" = None,
) -> tuple[ScenarioSet, SimOutput, Prediction, list[ScenarioSummary]]:
    """End-to-end what-if sweep: build, batch-simulate, summarize.

    :func:`build_scenario_set` -> :func:`run_scenarios` ->
    :func:`summarize_scenarios`, on the workload's device; returns all
    four artifacts so callers can rank candidates and read per-bin fields.
    ``shard``/``mesh`` split the lanes over a device mesh
    (:func:`run_scenarios`).
    """
    ss = build_scenario_set(workload, dc, scenarios, base_params,
                            max_hosts=max_hosts)
    sim, pred = run_scenarios(
        ss, max_hosts=ss.max_hosts, t_bins=t_bins,
        max_starts_per_bin=max_starts_per_bin, model=model,
        carbon_intensity=carbon_intensity, ambient_c=ambient_c, price=price,
        fused_readout=fused_readout, shard=shard, mesh=mesh,
    )
    return ss, sim, pred, summarize_scenarios(
        ss, sim, pred, carbon_intensity=carbon_intensity)
