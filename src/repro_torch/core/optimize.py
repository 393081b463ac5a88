"""Carbon-aware scenario optimizer (port of ``repro.core.optimize``).

The batched what-if engine (:mod:`repro_torch.core.scenarios`) evaluates a
hand-written list of candidates; the paper's stage 3 has the twin *find*
the operating point to propose.  :func:`optimize` searches the scenario
knob space (continuous power caps ``power_cap_w``, ``carbon_cap_base_w``,
``carbon_cap_slope``; the integer deferrable-job ``shift_bins``; discrete
topology and scheduler templates) against a scalarized
:class:`ObjectiveSpec` (weighted gCO2, energy and cost plus SLO penalties,
hard constraints masked to ``+inf``).

* Candidates are evaluated in fixed-shape batches of
  ``OptimizerConfig.batch_size`` lanes through
  :func:`repro_torch.core.scenarios.run_scenarios`: on the card one
  ``des_place`` launch places every lane of a batch, and with
  ``fused_readout=True`` one ``des_readout`` launch reads them out.
  ``max_hosts``/``max_backfill`` and the failure/PUE switches are pinned
  from the space, so every batch has the same shape.
* Deterministic under an explicit key: generation ``g`` draws from a CPU
  ``torch.Generator`` seeded from ``(key, g)``, so the knobs depend on
  neither the device nor the lanes' results.  The draws (``_draw_sample``,
  ``_draw_refine``) are split from the deterministic steps that turn them
  into knob points (``_knobs_from_draws``, ``_refine_from_draws``), which
  follow the JAX package line for line; its ``jax.random`` bits are not
  reproduced.
* Successive halving + coordinate refinement: generation 0 seeds the
  search (the discretized grid, or uniform samples); each later
  generation keeps a halving number of survivors and resamples around
  them with widths shrunk by ``refine_scale ** g``, mutating the structure
  now and then.
* The baseline and the incumbent ride every batch (lanes 0 and 1), and
  short batches are padded with incumbent replicas.

Scoring (:func:`score_batch`) is host-side float64 numpy, one
device-to-host copy of each leaf it reads a batch.  ``shard``/``mesh``
split every batch's lanes over a device mesh
(:func:`repro_torch.core.scenarios.run_scenarios`); the draws stay on the
host's generator, so a sharded search evaluates the same candidates.  The
JAX package's ``donate`` is not taken.

>>> spec = ObjectiveSpec(w_gco2_kg=1.0, w_energy_kwh=0.1,
...                      max_unplaced_jobs=0)
>>> spec.w_gco2_kg
1.0
>>> space = SearchSpace(power_cap_w=(40e3, 80e3), shift_bins=(0, 12))
>>> len(space.grid(levels=3))          # 1 structure x 3 caps x 3 shifts
9
>>> [s.shift_bins for s in space.grid(levels=3)][:3]
[0, 6, 12]
>>> SearchSpace(power_cap_w=(80e3, 40e3))
Traceback (most recent call last):
    ...
ValueError: power_cap_w range (80000.0, 40000.0) must have lo <= hi
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from repro_torch.core.power import PowerParams
from repro_torch.core.scenarios import (
    Scenario,
    ScenarioSummary,
    _host,
    build_scenario_set,
    run_scenarios,
    summarize_scenarios,
)
from repro_torch.traces.schema import DatacenterConfig, Workload

#: continuous axes of a :class:`SearchSpace` (name on Scenario == name here)
_CONT_AXES = ("power_cap_w", "carbon_cap_base_w", "carbon_cap_slope")


# -- objective ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """Scalarized operator objective the search minimizes.

    ``total = w_gco2_kg * gCO2[kg] + w_energy_kwh * energy[kWh]
    + w_cost * energy_cost[$]
    + w_wait * max(0, mean_wait - wait_target_bins)
    + w_makespan * max(0, makespan - makespan_target_bins)
    + w_unplaced * unplaced_jobs + w_throttled * cap_exceeded_bins``

    The penalty terms price SLO violations (queue wait, horizon makespan,
    unfinished work) and cap-throttled bins; the ``max_*`` fields are hard
    constraints: a candidate violating any of them is infeasible (objective
    ``+inf``) and never becomes the incumbent.  Weights must be finite and
    >= 0, at least one positive.  A non-zero ``w_gco2_kg`` needs a
    carbon-intensity trace at :func:`optimize` time; a non-zero ``w_cost``
    (or a ``max_energy_cost`` bound) a spot-price trace.
    """

    w_gco2_kg: float = 1.0          # per kg CO2
    w_energy_kwh: float = 0.0       # per kWh delivered
    w_wait: float = 1.0             # per mean queue-wait bin above target
    w_makespan: float = 0.0         # per makespan bin above target
    w_unplaced: float = 100.0       # per valid job never started
    w_throttled: float = 0.0        # per bin where the cap throttled demand
    w_cost: float = 0.0             # per $ of spot-priced energy
    wait_target_bins: float = 0.0
    makespan_target_bins: float = 0.0
    max_unplaced_jobs: int | None = None
    max_mean_wait_bins: float | None = None
    max_p99_wait_bins: float | None = None
    max_peak_power_w: float | None = None
    max_energy_cost: float | None = None

    _WEIGHTS = ("w_gco2_kg", "w_energy_kwh", "w_wait", "w_makespan",
                "w_unplaced", "w_throttled", "w_cost")

    def __post_init__(self):
        for k in (*self._WEIGHTS, "wait_target_bins", "makespan_target_bins"):
            v = getattr(self, k)
            if not (math.isfinite(v) and v >= 0):
                raise ValueError(
                    f"objective {k} must be finite and >= 0, got {v}")
        if not any(getattr(self, k) > 0 for k in self._WEIGHTS):
            raise ValueError("objective needs at least one positive weight")
        for k in ("max_unplaced_jobs", "max_mean_wait_bins",
                  "max_p99_wait_bins", "max_peak_power_w"):
            v = getattr(self, k)
            if v is not None and (math.isnan(v) or v < 0):
                raise ValueError(f"objective {k} must be >= 0, got {v}")
        # cost may be negative (spot markets pay consumers): only non-NaN
        if self.max_energy_cost is not None and math.isnan(self.max_energy_cost):
            raise ValueError("objective max_energy_cost must not be NaN")


#: per-candidate fields :func:`score_batch` reports (all ``[S]`` float64)
BREAKDOWN_FIELDS = (
    "gco2_kg", "energy_kwh", "mean_wait_bins", "p99_wait_bins",
    "makespan_bins", "unplaced_jobs", "peak_power_w", "cap_exceeded_bins",
    "penalty_wait", "penalty_makespan", "penalty_unplaced",
    "penalty_throttled", "energy_cost", "total",
)


def score_batch(spec: ObjectiveSpec, ss, sim, pred, *,
                t_bins: int) -> dict[str, np.ndarray]:
    """Score a batched sweep's outputs against an objective, host-side.

    Returns a dict of ``[S]`` float64 arrays: the :data:`BREAKDOWN_FIELDS`
    components, plus ``feasible`` (bool: every hard constraint holds and
    the total is finite) and ``objective`` (``total`` with infeasible lanes
    masked to ``+inf``, the array the search ranks on).  Each leaf read is
    copied to the host once.
    """
    start = _host(sim.job_start)                          # [S, J]
    submit = _host(ss.workload.submit_bin)                # [S, J] post-shift
    dur = np.maximum(_host(ss.workload.duration_bins), 1)
    valid = _host(ss.workload.valid)                      # [S, J]
    s_n = start.shape[0]

    placed = (start >= 0) & valid
    unplaced = ((start < 0) & valid).sum(axis=1).astype(np.float64)
    waits = np.where(placed, start - submit, 0).astype(np.float64)
    n_placed = placed.sum(axis=1)
    mean_wait = np.where(
        n_placed > 0, waits.sum(axis=1) / np.maximum(n_placed, 1), 0.0)
    p99_wait = np.zeros(s_n, np.float64)
    for s in range(s_n):                   # tiny per-lane percentile loop
        w = (start[s] - submit[s])[placed[s]]
        p99_wait[s] = float(np.percentile(w, 99)) if w.size else 0.0
    end = np.where(placed, np.minimum(start + dur, t_bins), 0)
    makespan = end.max(axis=1).astype(np.float64)

    power = _host(pred.power_w).astype(np.float64)          # [S, T] delivered
    demand = (_host(pred.power_demand_w).astype(np.float64)
              if pred.power_demand_w is not None else power)
    energy = _host(pred.energy_kwh).astype(np.float64).sum(axis=1)
    peak_power = power.max(axis=1)
    # bins where the enforced cap clipped demand (delivered < wanted)
    cap_exceeded = (demand > power).sum(axis=1).astype(np.float64)
    if pred.gco2 is not None:
        gco2_kg = _host(pred.gco2).astype(np.float64).sum(axis=1) / 1e3
    elif spec.w_gco2_kg > 0:
        raise ValueError(
            "objective weights gCO2 but the sweep ran without a "
            "carbon_intensity trace — pass carbon_intensity=[t_bins] "
            "gCO2/kWh or set w_gco2_kg=0")
    else:
        gco2_kg = np.full(s_n, np.nan)
    if pred.energy_cost is not None:
        cost = _host(pred.energy_cost).astype(np.float64).sum(axis=1)
    elif spec.w_cost > 0 or spec.max_energy_cost is not None:
        raise ValueError(
            "objective prices energy cost (w_cost/max_energy_cost) but the "
            "sweep ran without a price trace — pass price=[t_bins] $/kWh "
            "or drop the cost terms")
    else:
        cost = np.full(s_n, np.nan)

    pen_wait = spec.w_wait * np.maximum(mean_wait - spec.wait_target_bins, 0.0)
    pen_mk = spec.w_makespan * np.maximum(
        makespan - spec.makespan_target_bins, 0.0)
    pen_unp = spec.w_unplaced * unplaced
    pen_thr = spec.w_throttled * cap_exceeded
    total = (pen_wait + pen_mk + pen_unp + pen_thr
             + spec.w_energy_kwh * energy)
    if spec.w_gco2_kg > 0:
        total = total + spec.w_gco2_kg * gco2_kg
    if spec.w_cost > 0:
        total = total + spec.w_cost * cost

    feasible = np.isfinite(total)
    if spec.max_unplaced_jobs is not None:
        feasible &= unplaced <= spec.max_unplaced_jobs
    if spec.max_mean_wait_bins is not None:
        feasible &= mean_wait <= spec.max_mean_wait_bins
    if spec.max_p99_wait_bins is not None:
        feasible &= p99_wait <= spec.max_p99_wait_bins
    if spec.max_peak_power_w is not None:
        feasible &= peak_power <= spec.max_peak_power_w
    if spec.max_energy_cost is not None:
        feasible &= cost <= spec.max_energy_cost

    return {
        "gco2_kg": gco2_kg, "energy_kwh": energy,
        "mean_wait_bins": mean_wait, "p99_wait_bins": p99_wait,
        "makespan_bins": makespan, "unplaced_jobs": unplaced,
        "peak_power_w": peak_power, "cap_exceeded_bins": cap_exceeded,
        "penalty_wait": pen_wait, "penalty_makespan": pen_mk,
        "penalty_unplaced": pen_unp, "penalty_throttled": pen_thr,
        "energy_cost": cost,
        "total": total, "feasible": feasible,
        "objective": np.where(feasible, total, np.inf),
    }


# -- search space -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The knob space :func:`optimize` searches.

    ``structures`` are discrete candidates: :class:`Scenario` templates
    carrying the topology/scheduler axes (``num_hosts``, ``cores_per_host``,
    ``policy``, ``backfill_depth``) onto which the sampled continuous knobs
    are grafted.  Each ``(lo, hi)`` range activates one continuous axis
    (``None`` leaves the template's value); ``shift_bins`` is the integer
    deferrable-job time-shift axis.  Cap ranges must be positive; slope
    and shift ranges ordered and finite.
    """

    structures: tuple[Scenario, ...] = (Scenario(),)
    power_cap_w: tuple[float, float] | None = None
    carbon_cap_base_w: tuple[float, float] | None = None
    carbon_cap_slope: tuple[float, float] | None = None
    shift_bins: tuple[int, int] | None = None

    def __post_init__(self):
        if not self.structures:
            raise ValueError("search space needs at least one structure")
        for name in (*_CONT_AXES, "shift_bins"):
            rng = getattr(self, name)
            if rng is None:
                continue
            lo, hi = float(rng[0]), float(rng[1])
            if not (math.isfinite(lo) and math.isfinite(hi)):
                raise ValueError(f"{name} range {rng} must be finite")
            if lo > hi:
                raise ValueError(f"{name} range {rng} must have lo <= hi")
            if name in ("power_cap_w", "carbon_cap_base_w") and lo <= 0:
                raise ValueError(f"{name} range {rng} must be > 0 W")

    def active_axes(self) -> tuple[str, ...]:
        """Names of the activated continuous axes (+ ``shift_bins``)."""
        return tuple(n for n in (*_CONT_AXES, "shift_bins")
                     if getattr(self, n) is not None)

    def grid(self, levels: int = 3) -> list[Scenario]:
        """The exhaustive discretized grid: structures x ``levels`` per axis.

        Continuous axes discretize to ``levels`` evenly spaced points
        (``shift_bins`` to unique rounded integers); ``init="grid"`` seeds
        the search with this grid, so the incumbent is at least as good as
        its best point.
        """
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        axes: list[list] = []
        names: list[str] = []
        for name in _CONT_AXES:
            rng = getattr(self, name)
            if rng is not None:
                axes.append([float(v) for v in
                             np.unique(np.linspace(rng[0], rng[1], levels))])
                names.append(name)
        if self.shift_bins is not None:
            lo, hi = self.shift_bins
            axes.append([int(v) for v in np.unique(
                np.round(np.linspace(lo, hi, levels)).astype(np.int64))])
            names.append("shift_bins")
        out = []
        for si, tmpl in enumerate(self.structures):
            for combo in itertools.product(*axes):
                over = dict(zip(names, combo))
                name = "-".join(
                    [tmpl.name or f"t{si}"]
                    + [f"{n.split('_')[0]}{v:g}" for n, v in over.items()])
                out.append(dataclasses.replace(tmpl, name=name, **over))
        return out

    def max_hosts(self, dc: DatacenterConfig) -> int:
        """Padded host axis covering every structure plus the baseline."""
        return max([dc.num_hosts] + [
            s.num_hosts if s.num_hosts is not None else dc.num_hosts
            for s in self.structures])

    def max_backfill(self) -> int:
        """Backfill window covering every structure (baseline = 0)."""
        return max([0] + [int(s.backfill_depth) for s in self.structures])


# -- driver -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Search-driver knobs.

    ``batch_size`` lanes per evaluation batch (fixed); lanes 0/1 are the
    baseline and the incumbent, so each batch evaluates ``batch_size - 2``
    fresh candidates.  ``generations`` refinement rounds follow the init
    generation; round g keeps ``max(1, batch_size >> g)`` survivors
    (successive halving, unless ``survivors`` pins a count) and samples
    around them with widths shrunk by ``refine_scale ** g``.
    """

    batch_size: int = 16
    generations: int = 3
    init: str = "grid"              # "grid" | "random"
    init_levels: int = 3            # grid discretization per continuous axis
    survivors: int | None = None    # None = halving schedule
    refine_scale: float = 0.5
    mutate_structure_prob: float = 0.25

    def __post_init__(self):
        if self.batch_size < 4:
            raise ValueError(
                f"batch_size must be >= 4 (2 reserved lanes + candidates), "
                f"got {self.batch_size}")
        if self.generations < 0:
            raise ValueError(f"generations must be >= 0, got {self.generations}")
        if self.init not in ("grid", "random"):
            raise ValueError(f"init must be 'grid' or 'random', got {self.init!r}")
        if not 0.0 < self.refine_scale <= 1.0:
            raise ValueError(
                f"refine_scale must be in (0, 1], got {self.refine_scale}")


@dataclasses.dataclass(frozen=True)
class _Knobs:
    """One candidate's point in the search space (host-side, hashable)."""

    struct: int                          # index into structures; -1 = baseline
    power_cap_w: float | None = None
    carbon_cap_base_w: float | None = None
    carbon_cap_slope: float | None = None
    shift_bins: int | None = None


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluated operating point (host-side record)."""

    scenario: Scenario
    objective: float                     # +inf when infeasible
    feasible: bool
    breakdown: dict                      # BREAKDOWN_FIELDS -> float
    generation: int                      # 0 = init generation
    lane: int                            # lane within its evaluation batch


@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    """What the search found, plus everything needed to audit it.

    ``best`` is the incumbent: the feasible candidate with the lowest
    objective over every evaluation (``history``, in evaluation order).
    ``best_summary``/``baseline_summary`` come from the final batch, ready
    for :func:`repro_torch.core.feedback.propose_from_optimum`.
    ``incumbent_objective`` traces the incumbent after each batch.
    ``candidates`` counts fresh knob points; ``evaluations`` every lane
    scored, reserved lanes and padding replicas included.
    """

    best: Candidate
    baseline: Candidate
    best_summary: ScenarioSummary
    baseline_summary: ScenarioSummary
    history: tuple[Candidate, ...]
    incumbent_objective: np.ndarray      # [n_batches] float64
    candidates: int
    evaluations: int
    batches: int


def _scenario_from_knobs(space: SearchSpace, kn: _Knobs, name: str) -> Scenario:
    if kn.struct < 0:
        # the reserved baseline lane inherits structures[0]'s PUE model:
        # the PUE describes the facility, not an intervention knob
        t0 = space.structures[0]
        tmpl = Scenario(pue_base=t0.pue_base, pue_amb_coeff=t0.pue_amb_coeff,
                        pue_amb_ref=t0.pue_amb_ref,
                        pue_load_coeff=t0.pue_load_coeff)
    else:
        tmpl = space.structures[kn.struct]
    over: dict = {}
    # a None knob value on an active axis means "inherit the template"
    for axis in _CONT_AXES:
        if getattr(space, axis) is not None and getattr(kn, axis) is not None:
            over[axis] = getattr(kn, axis)
    if space.shift_bins is not None and kn.shift_bins is not None:
        over["shift_bins"] = int(kn.shift_bins)
    return dataclasses.replace(tmpl, name=name, **over)


def _knobs_from_scenario(space: SearchSpace, struct: int,
                         sc: Scenario) -> _Knobs:
    return _Knobs(
        struct=struct,
        power_cap_w=(sc.power_cap_w if space.power_cap_w is not None
                     else None),
        carbon_cap_base_w=(sc.carbon_cap_base_w
                           if space.carbon_cap_base_w is not None else None),
        carbon_cap_slope=(sc.carbon_cap_slope
                          if space.carbon_cap_slope is not None else None),
        shift_bins=(int(sc.shift_bins) if space.shift_bins is not None
                    else None),
    )


def _grid_knobs(space: SearchSpace, levels: int) -> list[_Knobs]:
    """The discretized grid as knob points (struct index preserved)."""
    scs = space.grid(levels)
    per_struct = len(scs) // len(space.structures)
    return [_knobs_from_scenario(space, i // per_struct, sc)
            for i, sc in enumerate(scs)]


# -- random draws: a CPU torch.Generator per generation -----------------------

def _key_seed(key: "int | torch.Generator") -> int:
    """The search's base seed: an int key itself (mod 2**64), or one 63-bit
    draw from a ``torch.Generator``."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=key))
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        return int(key) % 2 ** 64
    raise TypeError(f"key must be an int or a torch.Generator, got {type(key)!r}")


def _generator(key: int, g: int) -> torch.Generator:
    """Generation ``g``'s CPU generator, seeded from ``(key, g)``."""
    seed = np.random.SeedSequence([key, g]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(seed) % 2 ** 63)


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> np.ndarray:
    """``n`` float32 uniforms on ``[lo, hi]``, as float64."""
    u = torch.rand((n,), generator=gen, dtype=torch.float32)
    x = (u * np.float32(hi - lo) + np.float32(lo)).clamp(min=lo)
    return x.numpy().astype(np.float64)


def _draw_sample(space: SearchSpace, key: int, g: int, n: int) -> dict:
    """Generation ``g``'s draws for ``init="random"``: ``struct`` ``[n]``
    int in ``[0, len(structures))``; each active continuous axis ``[n]``
    float64 uniform on its range (float32 draws); ``shift_bins`` ``[n]``
    int uniform on ``[lo, hi]``."""
    gen = _generator(key, g)
    draws = {"struct": torch.randint(0, len(space.structures), (n,),
                                     generator=gen).numpy()}
    for axis in _CONT_AXES:
        rng = getattr(space, axis)
        if rng is not None:
            draws[axis] = _uniform(gen, n, float(rng[0]), float(rng[1]))
    if space.shift_bins is not None:
        lo, hi = space.shift_bins
        draws["shift_bins"] = torch.randint(int(lo), int(hi) + 1, (n,),
                                            generator=gen).numpy()
    return draws


def _draw_refine(space: SearchSpace, key: int, g: int, n: int,
                 mutate_prob: float) -> dict:
    """Generation ``g``'s draws for a refinement round: ``mutate`` ``[n]``
    bool (true with ``mutate_prob``), ``struct`` ``[n]`` int, and a float64
    standard normal ``[n]`` (float32 draws) for each continuous axis and
    for ``shift_bins``."""
    gen = _generator(key, g)
    draws = {
        "mutate": (torch.rand((n,), generator=gen) < mutate_prob).numpy(),
        "struct": torch.randint(0, len(space.structures), (n,),
                                generator=gen).numpy(),
    }
    for axis in (*_CONT_AXES, "shift_bins"):
        draws[axis] = torch.randn((n,), generator=gen).numpy().astype(np.float64)
    return draws


def _knobs_from_draws(space: SearchSpace, draws: dict, n: int) -> list[_Knobs]:
    """n uniform samples over the space (init="random") from their draws."""
    struct = np.asarray(draws["struct"])
    vals = {a: np.asarray(draws[a]) for a in (*_CONT_AXES, "shift_bins")
            if a in draws}
    return [_Knobs(struct=int(struct[i]),
                   **{a: (float(v[i]) if a != "shift_bins" else int(v[i]))
                      for a, v in vals.items()})
            for i in range(n)]


def _refine_from_draws(space: SearchSpace, draws: dict, parents: list[_Knobs],
                       n: int, width_scale: float) -> list[_Knobs]:
    """n children around the survivors from their draws: gaussian
    coordinate refinement on the continuous axes (clipped to range),
    structure mutation where ``mutate``."""
    mutate = np.asarray(draws["mutate"])
    rand_struct = np.asarray(draws["struct"])
    normals = {axis: np.asarray(draws[axis], np.float64) for axis in _CONT_AXES}
    shift_n = np.asarray(draws["shift_bins"], np.float64)

    out = []
    for i in range(n):
        p = parents[i % len(parents)]
        fields: dict = {"struct": (int(rand_struct[i]) if mutate[i]
                                   else p.struct)}
        for axis in _CONT_AXES:
            rng = getattr(space, axis)
            if rng is None:
                continue
            lo, hi = float(rng[0]), float(rng[1])
            base = getattr(p, axis)
            base = 0.5 * (lo + hi) if base is None else float(base)
            width = 0.5 * (hi - lo) * width_scale
            fields[axis] = float(np.clip(base + normals[axis][i] * width,
                                         lo, hi))
        if space.shift_bins is not None:
            lo, hi = space.shift_bins
            base = (0.5 * (lo + hi) if p.shift_bins is None
                    else float(p.shift_bins))
            width = max(0.5 * (hi - lo) * width_scale, 1.0)
            fields["shift_bins"] = int(np.clip(
                np.round(base + shift_n[i] * width), lo, hi))
        out.append(_Knobs(**fields))
    return out


def optimize(
    workload: Workload,
    dc: DatacenterConfig,
    space: SearchSpace,
    objective: ObjectiveSpec = ObjectiveSpec(),
    *,
    t_bins: int,
    base_params: PowerParams = PowerParams(),
    carbon_intensity=None,
    ambient_c=None,
    price=None,
    key: "int | torch.Generator" = 0,
    config: OptimizerConfig = OptimizerConfig(),
    model: str = "opendc",
    max_starts_per_bin: int = 64,
    fused_readout: bool = False,
    shard: bool = False,
    mesh=None,
) -> OptimizeResult:
    """Search the scenario space for the best feasible operating point.

    Runs generations of fixed-shape candidate batches through
    :func:`repro_torch.core.scenarios.run_scenarios` on the workload's
    device, scores every lane against ``objective`` (:func:`score_batch`)
    and refines around survivors.  Deterministic given ``key`` (an int
    seed or a ``torch.Generator``, from which one seed is drawn).
    ``fused_readout`` selects the fused readout kernel inside the
    evaluator (the JAX package's ``use_pallas``); ``shard``/``mesh``
    split each batch over a device mesh, bit for bit equal to the
    unsharded search (a ``mesh`` without ``shard=True`` raises).

    Raises ``ValueError`` when the space or the objective needs a trace
    that was not supplied, or when no evaluated candidate (baseline
    included) satisfies the hard constraints.
    """
    if mesh is not None and not shard:
        raise ValueError("mesh given but shard=False")
    key = _key_seed(key)
    if carbon_intensity is None and (space.carbon_cap_base_w is not None
                                     or space.carbon_cap_slope is not None):
        raise ValueError(
            "search space activates carbon-aware cap axes but no "
            "carbon_intensity trace was supplied")
    if carbon_intensity is None and objective.w_gco2_kg > 0:
        raise ValueError(
            "objective weights gCO2 (w_gco2_kg > 0) but no carbon_intensity "
            "trace was supplied — pass one or set w_gco2_kg=0")
    if price is None and (objective.w_cost > 0
                          or objective.max_energy_cost is not None):
        raise ValueError(
            "objective prices energy cost (w_cost/max_energy_cost) but no "
            "price trace was supplied — pass price=[t_bins] $/kWh or drop "
            "the cost terms")
    if ambient_c is None and any(s.pue_amb_coeff != 0.0
                                 for s in space.structures):
        raise ValueError(
            "search-space structure(s) set pue_amb_coeff but no ambient_c "
            "trace was supplied — pass ambient_c=[t_bins] °C")

    mh = space.max_hosts(dc)
    mb = space.max_backfill()
    # pinned from the space, not per batch: a generation whose mutations
    # drop every failure/PUE lane keeps the batch's shape and machinery
    has_failures = any(s.failures for s in space.structures)
    pue_on = any(s.pue_base is not None for s in space.structures)
    s_lanes = config.batch_size
    per_batch = s_lanes - 2              # lanes 0/1 = baseline/incumbent
    baseline_kn = _Knobs(struct=-1)
    if space.shift_bins is not None:
        baseline_kn = dataclasses.replace(baseline_kn, shift_bins=0)

    history: list[Candidate] = []
    history_kn: list[_Knobs] = []        # knob point per history entry
    incumbent_trace: list[float] = []
    incumbent: Candidate | None = None
    incumbent_kn = baseline_kn
    baseline_cand: Candidate | None = None
    final_lanes: list[_Knobs] = []
    final_artifacts = None               # (ss, sim, pred) of the last batch
    n_fresh = 0                          # fresh candidate lanes (no padding)

    def eval_batch(knobs: list[_Knobs], gen: int) -> None:
        nonlocal incumbent, incumbent_kn, baseline_cand, final_artifacts, \
            final_lanes, n_fresh
        # fixed S: pad short batches with incumbent replicas
        knobs = list(knobs)[:per_batch]
        n_fresh += len(knobs)
        knobs += [incumbent_kn] * (per_batch - len(knobs))
        lanes = [baseline_kn, incumbent_kn, *knobs]
        batch = len(incumbent_trace)     # names stay unique across batches
        scenarios = [
            _scenario_from_knobs(space, kn, name=(
                "baseline" if i == 0 else
                "incumbent" if i == 1 else f"g{gen}b{batch}-l{i}"))
            for i, kn in enumerate(lanes)]
        ss = build_scenario_set(workload, dc, scenarios, base_params,
                                max_hosts=mh, max_backfill=mb,
                                has_failures=has_failures, pue_on=pue_on)
        sim, pred = run_scenarios(
            ss, max_hosts=mh, t_bins=t_bins,
            max_starts_per_bin=max_starts_per_bin, model=model,
            carbon_intensity=carbon_intensity, ambient_c=ambient_c,
            price=price, fused_readout=fused_readout, shard=shard, mesh=mesh)
        scores = score_batch(objective, ss, sim, pred, t_bins=t_bins)
        for i, kn in enumerate(lanes):
            cand = Candidate(
                scenario=scenarios[i],
                objective=float(scores["objective"][i]),
                feasible=bool(scores["feasible"][i]),
                # no-price sweeps mark cost absent with None, not NaN, so
                # equal breakdowns compare equal
                breakdown={
                    f: (None if f == "energy_cost"
                        and not np.isfinite(scores[f][i])
                        else float(scores[f][i]))
                    for f in BREAKDOWN_FIELDS},
                generation=gen, lane=i)
            history.append(cand)
            history_kn.append(kn)
            if i == 0 and baseline_cand is None:
                baseline_cand = cand
            if cand.feasible and (incumbent is None
                                  or cand.objective < incumbent.objective):
                incumbent, incumbent_kn = cand, kn
        incumbent_trace.append(
            incumbent.objective if incumbent is not None else math.inf)
        final_artifacts, final_lanes = (ss, sim, pred), lanes

    # generation 0: seed the search
    if config.init == "grid":
        seeds = _grid_knobs(space, config.init_levels)
    else:
        seeds = _knobs_from_draws(space, _draw_sample(space, key, 0, per_batch),
                                  per_batch)
    n_batches0 = max(1, -(-len(seeds) // per_batch))
    for b in range(n_batches0):
        eval_batch(seeds[b * per_batch:(b + 1) * per_batch], gen=0)

    # refinement generations: successive halving + coordinate refinement
    for g in range(1, config.generations + 1):
        k_g = (config.survivors if config.survivors is not None
               else max(1, s_lanes >> g))
        # survivors: the best distinct knob points evaluated so far
        ranked = sorted((i for i, c in enumerate(history) if c.feasible),
                        key=lambda i: history[i].objective)
        seen, parents = set(), []
        for i in ranked:
            kn = history_kn[i]
            if kn not in seen:
                seen.add(kn)
                parents.append(kn)
            if len(parents) >= k_g:
                break
        if not parents:
            parents = [baseline_kn]
        draws = _draw_refine(space, key, g, per_batch,
                             config.mutate_structure_prob)
        children = _refine_from_draws(space, draws, parents, per_batch,
                                      width_scale=config.refine_scale ** g)
        eval_batch(children, gen=g)

    if incumbent is None:
        raise ValueError(
            "no feasible candidate found (baseline included) — relax the "
            "hard constraints or widen the search space")

    # operator-grade summaries from the final batch: lane 0 is the baseline,
    # and the final incumbent is one of its lanes (lane 1 carries the
    # incumbent as of the batch's start; an improvement is one of its own)
    ss_f, sim_f, pred_f = final_artifacts
    summaries = summarize_scenarios(ss_f, sim_f, pred_f,
                                    carbon_intensity=carbon_intensity)
    best_lane = final_lanes.index(incumbent_kn)
    return OptimizeResult(
        best=incumbent,
        baseline=baseline_cand,
        best_summary=dataclasses.replace(summaries[best_lane],
                                         name=incumbent.scenario.name),
        baseline_summary=summaries[0],
        history=tuple(history),
        incumbent_objective=np.asarray(incumbent_trace, np.float64),
        candidates=n_fresh,
        evaluations=len(history),
        batches=len(incumbent_trace),
    )
