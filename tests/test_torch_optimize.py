"""The port's scenario optimizer against the JAX package's.

``score_batch``, ``SearchSpace``, the validation of the three specs, the
deterministic halves of the samplers (``_knobs_from_draws``,
``_refine_from_draws``) and the whole search, on ``tests/test_optimize.py``'s
twin (4 x 8 hosts, 48 bins, 24 jobs from numpy seed 3).  The port draws its
knobs from a CPU ``torch.Generator``, not ``jax.random``: parity is held by
feeding the JAX package's draws, computed here from the same key as
``optimize.py`` computes them, into the port's deterministic steps (and,
for the whole search, by monkeypatching the port's ``_draw_sample`` /
``_draw_refine``; nothing in the JAX package changes).  Bars: knobs, names,
feasibility, lanes and integer breakdown terms exact; float terms and
objectives at rtol 5e-6 (the twin's float bar).  Then the port's own
invariants from ``tests/test_optimize.py`` and ``test_optimize_property.py``
under hypothesis.
"""

import dataclasses
import importlib
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import scenarios as jsc  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.traces import schema as jschema  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import scenarios as psc  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.traces import schema  # noqa: E402
from repro_torch.traces.carbon import make_diurnal_carbon  # noqa: E402
from repro_torch.traces.price import make_diurnal_price  # noqa: E402

# the packages' ``core`` export the function ``optimize`` under the module's name
jopt = importlib.import_module("repro.core.optimize")
popt = importlib.import_module("repro_torch.core.optimize")

TWIN_RTOL = 5e-6
T_BINS = 48
INTS = ("unplaced_jobs", "cap_exceeded_bins", "makespan_bins", "mean_wait_bins",
        "p99_wait_bins")

JAX = types.SimpleNamespace(opt=jopt, Scenario=jsc.Scenario, PowerParams=JPowerParams,
                            DC=jschema.DatacenterConfig, build=jsc.build_scenario_set,
                            run=jsc.run_scenarios)
PORT = types.SimpleNamespace(opt=popt, Scenario=psc.Scenario, PowerParams=PowerParams,
                             DC=schema.DatacenterConfig, build=psc.build_scenario_set,
                             run=psc.run_scenarios)


def _jax_workload():
    rng = np.random.default_rng(3)
    j = 24
    return jschema.Workload(
        jnp.asarray(np.sort(rng.integers(0, 24, j)).astype(np.int32)),
        jnp.asarray(rng.integers(1, 8, j).astype(np.int32)),
        jnp.asarray(rng.integers(1, 8, j).astype(np.int32)),
        jnp.asarray(rng.uniform(0.2, 1.0, (j, 3)).astype(np.float32)),
        jnp.ones((j,), bool),
        deferrable=jnp.asarray(rng.random(j) < 0.5))


JW = _jax_workload()
PW = convert.workload_from_numpy(JW, device="cpu")
TRACES = dict(carbon_intensity=make_diurnal_carbon(T_BINS, seed=2),
              price=make_diurnal_price(T_BINS, seed=5))


def workload(m):
    return JW if m is JAX else PW


def dc(m):
    return m.DC(num_hosts=4, cores_per_host=8)


def space(m, **kw):
    """``tests/test_optimize.py``'s space."""
    base = dict(structures=(m.Scenario(name="wf"),
                            m.Scenario(name="bf", policy="best_fit", backfill_depth=4)),
                carbon_cap_base_w=(800.0, 2000.0), carbon_cap_slope=(-2.0, 0.0),
                shift_bins=(0, 12))
    base.update(kw)
    return m.opt.SearchSpace(**base)


def objective(m, **kw):
    base = dict(w_gco2_kg=1.0, w_wait=0.05, w_unplaced=10.0, w_throttled=0.02)
    base.update(kw)
    return m.opt.ObjectiveSpec(**base)


def config(m, **kw):
    base = dict(batch_size=8, generations=2, init="grid", init_levels=2)
    base.update(kw)
    return m.opt.OptimizerConfig(**base)


def sc_key(sc):
    """A Scenario of either package as comparable values."""
    return tuple((f.name, len(sc.failures) if f.name == "failures" else getattr(sc, f.name))
                 for f in dataclasses.fields(sc))


def knob_key(kn):
    return dataclasses.astuple(kn)


# -- score_batch --------------------------------------------------------------

SCORE_MIX = lambda m: [  # noqa: E731
    m.Scenario(name="base"), m.Scenario(name="cap", power_cap_w=1200.0),
    m.Scenario(name="shift", shift_bins=6),
    m.Scenario(name="bf", policy="best_fit", backfill_depth=4, carbon_cap_base_w=900.0,
               carbon_cap_slope=-1.0),
    m.Scenario(name="small", num_hosts=2, util_scale=1.3),
    m.Scenario(name="pue", pue_base=1.2, pue_load_coeff=0.1, power_cap_w=1500.0)]

OBJECTIVES = {
    "carbon": dict(w_gco2_kg=1.0, w_wait=0.05, w_unplaced=10.0, w_throttled=0.02,
                   max_peak_power_w=1100.0),
    "cost": dict(w_gco2_kg=0.0, w_cost=3.0, w_energy_kwh=0.5, w_makespan=0.1,
                 makespan_target_bins=20.0, wait_target_bins=1.0, max_energy_cost=0.12,
                 max_unplaced_jobs=2, max_mean_wait_bins=6.0, max_p99_wait_bins=20.0),
    "no traces": dict(w_gco2_kg=0.0, w_energy_kwh=1.0, w_wait=0.5),
}


def _scores(m, name):
    mix = [s for s in SCORE_MIX(m) if name != "no traces" or s.carbon_cap_base_w is None]
    ss = m.build(workload(m), dc(m), mix, m.PowerParams(p_idle=60.0, p_max=300.0))
    traces = {} if name == "no traces" else TRACES
    sim, pred = m.run(ss, max_hosts=ss.max_hosts, t_bins=T_BINS, **traces)
    return m.opt.score_batch(m.opt.ObjectiveSpec(**OBJECTIVES[name]), ss, sim, pred,
                             t_bins=T_BINS)


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_score_batch_matches_jax(name):
    want, got = _scores(JAX, name), _scores(PORT, name)
    assert set(got) == set(want) == set(jopt.BREAKDOWN_FIELDS) | {"feasible", "objective"}
    for f in jopt.BREAKDOWN_FIELDS:
        assert got[f].dtype == np.float64, f
        if f in INTS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], rtol=TWIN_RTOL, err_msg=f)
    np.testing.assert_array_equal(got["feasible"], want["feasible"])
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=TWIN_RTOL)
    if name != "no traces":
        assert 0 < got["feasible"].sum() < len(got["feasible"])


@pytest.mark.parametrize("kw", [dict(w_gco2_kg=1.0), dict(w_gco2_kg=0.0, w_cost=1.0),
                                dict(w_gco2_kg=0.0, max_energy_cost=1.0)])
def test_score_batch_missing_trace_raises_as_jax(kw):
    msgs = []
    for m in (JAX, PORT):
        ss = m.build(workload(m), dc(m), SCORE_MIX(m)[:2])
        sim, pred = m.run(ss, max_hosts=ss.max_hosts, t_bins=T_BINS)
        with pytest.raises(ValueError) as e:
            m.opt.score_batch(m.opt.ObjectiveSpec(**kw), ss, sim, pred, t_bins=T_BINS)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- search space and validation ----------------------------------------------

SPACES = {
    "example": lambda m: space(m),
    "caps and topology": lambda m: m.opt.SearchSpace(
        structures=(m.Scenario(name="h6", num_hosts=6, policy="first_fit", backfill_depth=3),
                    m.Scenario(), m.Scenario(name="h2", num_hosts=2)),
        power_cap_w=(900.0, 900.0), shift_bins=(3, 4)),
    "no axes": lambda m: m.opt.SearchSpace(),
}


@pytest.mark.parametrize("name", list(SPACES))
@pytest.mark.parametrize("levels", [1, 2, 3, 5])
def test_search_space_matches_jax(name, levels):
    want, got = SPACES[name](JAX), SPACES[name](PORT)
    assert got.active_axes() == want.active_axes()
    assert [sc_key(s) for s in got.grid(levels)] == [sc_key(s) for s in want.grid(levels)]
    assert got.max_hosts(dc(PORT)) == want.max_hosts(dc(JAX))
    assert got.max_backfill() == want.max_backfill()
    assert ([knob_key(k) for k in popt._grid_knobs(got, levels)]
            == [knob_key(k) for k in jopt._grid_knobs(want, levels)])


BAD_SPECS = [
    ("ObjectiveSpec", dict(w_gco2_kg=float("nan"))),
    ("ObjectiveSpec", dict(w_energy_kwh=-1.0)),
    ("ObjectiveSpec", dict(w_wait=float("inf"))),
    ("ObjectiveSpec", dict(wait_target_bins=-2.0)),
    ("ObjectiveSpec", dict(w_gco2_kg=0.0, w_wait=0.0, w_unplaced=0.0)),
    ("ObjectiveSpec", dict(max_unplaced_jobs=-1)),
    ("ObjectiveSpec", dict(max_peak_power_w=float("nan"))),
    ("ObjectiveSpec", dict(max_energy_cost=float("nan"))),
    ("SearchSpace", dict(structures=())),
    ("SearchSpace", dict(shift_bins=(6, 0))),
    ("SearchSpace", dict(power_cap_w=(0.0, 100.0))),
    ("SearchSpace", dict(carbon_cap_base_w=(-5.0, 100.0))),
    ("SearchSpace", dict(carbon_cap_slope=(float("-inf"), 0.0))),
    ("OptimizerConfig", dict(batch_size=2)),
    ("OptimizerConfig", dict(generations=-1)),
    ("OptimizerConfig", dict(init="annealing")),
    ("OptimizerConfig", dict(refine_scale=0.0)),
    ("OptimizerConfig", dict(refine_scale=1.5)),
]
GOOD_SPECS = [
    ("ObjectiveSpec", dict(max_energy_cost=-3.0)),
    ("ObjectiveSpec", dict(w_gco2_kg=0.0, w_throttled=1.0, max_unplaced_jobs=0)),
    ("SearchSpace", dict(carbon_cap_slope=(-3.0, -3.0), shift_bins=(0, 0))),
    ("OptimizerConfig", dict(batch_size=4, generations=0, refine_scale=1.0)),
]


@pytest.mark.parametrize("cls,kw", BAD_SPECS + GOOD_SPECS,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(BAD_SPECS + GOOD_SPECS)])
def test_spec_validation_matches_jax(cls, kw):
    outcome = []
    for m in (JAX, PORT):
        try:
            getattr(m.opt, cls)(**kw)
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == ((cls, kw) in GOOD_SPECS)
    with pytest.raises(ValueError, match="lo <= hi"):
        popt.SearchSpace(power_cap_w=(80e3, 40e3))


# -- samplers: JAX's draws through the port's deterministic steps -------------

def jax_sample_draws(sp, key, n):
    """The draws ``repro/core/optimize.py:471-483`` makes."""
    ks = jax.random.split(key, 5)
    draws = {"struct": np.asarray(jax.random.randint(ks[0], (n,), 0, len(sp.structures)))}
    for i, axis in enumerate(popt._CONT_AXES):
        rng = getattr(sp, axis)
        if rng is not None:
            draws[axis] = np.asarray(jax.random.uniform(
                ks[1 + i], (n,), minval=rng[0], maxval=rng[1]), np.float64)
    if sp.shift_bins is not None:
        lo, hi = sp.shift_bins
        draws["shift_bins"] = np.asarray(jax.random.randint(ks[4], (n,), lo, hi + 1))
    return draws


def jax_refine_draws(sp, key, n, mutate_prob):
    """The draws ``repro/core/optimize.py:495-502`` makes."""
    ks = jax.random.split(key, 6)
    draws = {"mutate": np.asarray(jax.random.bernoulli(ks[0], mutate_prob, (n,))),
             "struct": np.asarray(jax.random.randint(ks[1], (n,), 0, len(sp.structures)))}
    for i, axis in enumerate(popt._CONT_AXES):
        draws[axis] = np.asarray(jax.random.normal(ks[2 + i], (n,)), np.float64)
    draws["shift_bins"] = np.asarray(jax.random.normal(ks[5], (n,)), np.float64)
    return draws


def to_port_knobs(kns):
    return [popt._Knobs(*dataclasses.astuple(k)) for k in kns]


@pytest.mark.parametrize("name", ["example", "caps and topology", "no axes"])
@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_match_jax_on_jax_draws(name, seed):
    jsp, psp = SPACES[name](JAX), SPACES[name](PORT)
    n = 13
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    want = jopt._sample_knobs(jsp, key, n)
    got = popt._knobs_from_draws(psp, jax_sample_draws(jsp, key, n), n)
    assert [knob_key(k) for k in got] == [knob_key(k) for k in want]
    parents = want[:3] + [jopt._Knobs(struct=-1)]
    for g, (scale, p) in enumerate([(0.5, 0.25), (0.125, 0.9), (1.0, 0.0)], start=1):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), g)
        want_c = jopt._refine_knobs(jsp, key, parents, n, width_scale=scale,
                                    mutate_prob=p)
        got_c = popt._refine_from_draws(psp, jax_refine_draws(jsp, key, n, p),
                                        to_port_knobs(parents), n, width_scale=scale)
        assert [knob_key(k) for k in got_c] == [knob_key(k) for k in want_c]


def test_port_draws_have_jax_shapes_and_ranges():
    """The port's own draws: the same keys, shapes, types and ranges as
    JAX's; a function of ``(key, g)`` alone."""
    sp = space(PORT)
    d = popt._draw_sample(sp, 5, 0, 400)
    assert set(d) == {"struct", "carbon_cap_base_w", "carbon_cap_slope", "shift_bins"}
    assert d["struct"].shape == (400,) and set(np.unique(d["struct"])) == {0, 1}
    assert d["carbon_cap_base_w"].dtype == np.float64
    assert 800.0 <= d["carbon_cap_base_w"].min() and d["carbon_cap_base_w"].max() <= 2000.0
    assert set(np.unique(d["shift_bins"])) == set(range(13))
    r = popt._draw_refine(sp, 5, 1, 400, 0.25)
    assert set(r) == {"mutate", "struct", "power_cap_w", "carbon_cap_base_w",
                      "carbon_cap_slope", "shift_bins"}
    assert r["mutate"].dtype == bool and 0.15 < r["mutate"].mean() < 0.35
    assert abs(r["shift_bins"].std() - 1.0) < 0.15
    again = popt._draw_refine(sp, 5, 1, 400, 0.25)
    assert all(np.array_equal(r[k], again[k]) for k in r)
    other = popt._draw_refine(sp, 5, 2, 400, 0.25)
    assert not np.array_equal(r["shift_bins"], other["shift_bins"])


# -- the whole search, with JAX's draws injected ------------------------------

def inject_jax_draws(monkeypatch):
    def sample(sp, key, g, n):
        return jax_sample_draws(sp, jax.random.fold_in(jax.random.PRNGKey(key), g), n)

    def refine(sp, key, g, n, mutate_prob):
        return jax_refine_draws(sp, jax.random.fold_in(jax.random.PRNGKey(key), g), n,
                                mutate_prob)

    monkeypatch.setattr(popt, "_draw_sample", sample)
    monkeypatch.setattr(popt, "_draw_refine", refine)


def assert_same_search(got, want):
    assert len(got.history) == len(want.history)
    for a, b in zip(got.history, want.history):
        assert sc_key(a.scenario) == sc_key(b.scenario)
        assert (a.feasible, a.generation, a.lane) == (b.feasible, b.generation, b.lane)
        assert a.objective == pytest.approx(b.objective, rel=TWIN_RTOL)
        for f in jopt.BREAKDOWN_FIELDS:
            x, y = a.breakdown[f], b.breakdown[f]
            if y is None or (isinstance(y, float) and math.isnan(y)):
                assert x is None if y is None else math.isnan(x), f
            elif f in INTS:
                assert x == y, f
            else:
                assert x == pytest.approx(y, rel=TWIN_RTOL, abs=1e-12), f
    assert sc_key(got.best.scenario) == sc_key(want.best.scenario)
    assert sc_key(got.baseline.scenario) == sc_key(want.baseline.scenario)
    np.testing.assert_allclose(got.incumbent_objective, want.incumbent_objective,
                               rtol=TWIN_RTOL)
    assert (got.candidates, got.evaluations, got.batches) == \
        (want.candidates, want.evaluations, want.batches)
    for s, t in ((got.best_summary, want.best_summary),
                 (got.baseline_summary, want.baseline_summary)):
        for f, vb in t.__dict__.items():
            va = s.__dict__[f]
            if isinstance(vb, float) and not math.isnan(vb):
                assert va == pytest.approx(vb, rel=TWIN_RTOL), f
            elif not isinstance(vb, float):
                assert va == vb, f


SEARCHES = {
    "grid": (dict(), dict(), False),
    "random": (dict(init="random"), dict(), False),
    "grid, fused readout": (dict(), dict(), True),
    "random, caps, cost, fused": (
        dict(init="random", batch_size=6, generations=3, survivors=2),
        dict(w_gco2_kg=0.0, w_cost=2.0, max_peak_power_w=1450.0), True),
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_optimize_matches_jax_with_injected_draws(name, monkeypatch):
    cfg_kw, obj_kw, fused = SEARCHES[name]
    sp = (lambda m: space(m, power_cap_w=(1200.0, 2500.0))) if "caps" in name else space
    inject_jax_draws(monkeypatch)
    want = jopt.optimize(JW, dc(JAX), sp(JAX), objective(JAX, **obj_kw), t_bins=T_BINS,
                         key=3, config=config(JAX, **cfg_kw), use_pallas=fused, **TRACES)
    got = popt.optimize(PW, dc(PORT), sp(PORT), objective(PORT, **obj_kw), t_bins=T_BINS,
                        key=3, config=config(PORT, **cfg_kw), fused_readout=fused,
                        **TRACES)
    assert_same_search(got, want)
    assert any(c.generation > 0 and c.lane > 1 for c in got.history)


@pytest.mark.parametrize("kw", [
    dict(space=dict(), objective=dict(), traces=dict()),
    dict(space=dict(carbon_cap_slope=None, carbon_cap_base_w=(900.0, 1000.0)),
         objective=dict(w_gco2_kg=0.0, w_energy_kwh=1.0), traces=dict()),
    dict(space=dict(), objective=dict(w_cost=1.0), traces=dict(carbon_intensity=True)),
    dict(space=dict(structures=(None,)), objective=dict(),
         traces=dict(carbon_intensity=True)),
])
def test_optimize_rejects_missing_traces_as_jax(kw):
    msgs = []
    for m in (JAX, PORT):
        sp_kw = dict(kw["space"])
        if sp_kw.get("structures") == (None,):
            sp_kw["structures"] = (m.Scenario(pue_base=1.2, pue_amb_coeff=0.05),)
        traces = {k: TRACES[k] for k in kw["traces"]}
        with pytest.raises(ValueError) as e:
            m.opt.optimize(workload(m), dc(m), space(m, **sp_kw),
                           objective(m, **kw["objective"]), t_bins=T_BINS, key=0,
                           config=config(m), **traces)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the port's own invariants -------------------------------------------------

def port_search(key=0, **obj_kw):
    return popt.optimize(PW, dc(PORT), space(PORT), objective(PORT, **obj_kw),
                         t_bins=T_BINS, carbon_intensity=TRACES["carbon_intensity"],
                         key=key, config=config(PORT, init="random", batch_size=6))


def test_not_worse_than_the_exhaustive_grid():
    sp, obj = space(PORT), objective(PORT)
    res = popt.optimize(PW, dc(PORT), sp, obj, t_bins=T_BINS,
                        carbon_intensity=TRACES["carbon_intensity"], key=0,
                        config=config(PORT))
    assert res.best.feasible
    ss = psc.build_scenario_set(PW, dc(PORT), sp.grid(levels=2),
                                max_hosts=sp.max_hosts(dc(PORT)),
                                max_backfill=sp.max_backfill())
    sim, pred = psc.run_scenarios(ss, max_hosts=ss.max_hosts, t_bins=T_BINS,
                                  carbon_intensity=TRACES["carbon_intensity"])
    grid_best = popt.score_batch(obj, ss, sim, pred, t_bins=T_BINS)["objective"].min()
    assert res.best.objective <= grid_best
    assert res.best.objective == min(c.objective for c in res.history if c.feasible)
    assert (np.diff(res.incumbent_objective) <= 0).all()


@given(key=st.integers(0, 2**31 - 1))
@settings(max_examples=4, deadline=None)
def test_incumbent_and_baseline_reported(key):
    res = port_search(key)
    assert res.baseline.scenario.name == "baseline"
    assert res.baseline.generation == 0 and res.baseline.lane == 0
    assert res.baseline_summary.policy == "worst_fit"
    assert res.baseline_summary.num_hosts == 4
    assert res.best.objective <= res.baseline.objective
    feas = [c.objective for c in res.history if c.feasible]
    assert res.best.objective == min(feas)
    assert (np.diff(res.incumbent_objective) <= 0).all()


@given(key=st.integers(0, 2**31 - 1), max_unplaced=st.integers(0, 4),
       max_wait=st.floats(0.5, 20.0), max_peak=st.floats(900.0, 2000.0))
@settings(max_examples=5, deadline=None)
def test_winner_never_violates_hard_constraints(key, max_unplaced, max_wait, max_peak):
    try:
        res = port_search(key, max_unplaced_jobs=max_unplaced, max_mean_wait_bins=max_wait,
                          max_peak_power_w=max_peak)
    except ValueError as e:
        assert "no feasible candidate" in str(e)
        return
    b = res.best.breakdown
    assert b["unplaced_jobs"] <= max_unplaced and b["mean_wait_bins"] <= max_wait
    assert b["peak_power_w"] <= max_peak
    for c in res.history:
        assert (c.objective == np.inf) == (not c.feasible)


def test_fully_infeasible_space_raises():
    with pytest.raises(ValueError, match="no feasible candidate"):
        port_search(max_peak_power_w=1.0)


@given(key=st.integers(0, 2**31 - 1))
@settings(max_examples=3, deadline=None)
def test_fixed_key_is_bit_reproducible(key):
    a, b = port_search(key), port_search(key)
    assert [c.scenario for c in a.history] == [c.scenario for c in b.history]
    assert [c.objective for c in a.history] == [c.objective for c in b.history]
    assert [c.breakdown for c in a.history] == [c.breakdown for c in b.history]
    np.testing.assert_array_equal(a.incumbent_objective, b.incumbent_objective)
    assert a.best.scenario == b.best.scenario


def test_generator_key_is_reproducible_and_differs_from_another_seed():
    def run(seed):
        return popt.optimize(PW, dc(PORT), space(PORT), objective(PORT), t_bins=T_BINS,
                             carbon_intensity=TRACES["carbon_intensity"],
                             key=torch.Generator().manual_seed(seed),
                             config=config(PORT, init="random", generations=1))
    a, b, c = run(11), run(11), run(12)
    assert [x.scenario for x in a.history] == [x.scenario for x in b.history]
    assert [x.scenario for x in a.history] != [x.scenario for x in c.history]
    with pytest.raises(TypeError, match="key"):
        popt.optimize(PW, dc(PORT), space(PORT), objective(PORT), t_bins=T_BINS,
                      carbon_intensity=TRACES["carbon_intensity"], key=1.5)


def test_uses_the_given_power_parameters():
    sp = popt.SearchSpace(structures=(psc.Scenario(name="wf"),), shift_bins=(0, 6))
    obj = popt.ObjectiveSpec(w_gco2_kg=1.0)
    cfg = config(PORT, generations=0, batch_size=4)
    lo, hi = (popt.optimize(PW, dc(PORT), sp, obj, t_bins=T_BINS,
                            base_params=PowerParams(p_idle=pi, p_max=pm, r=2.0),
                            carbon_intensity=TRACES["carbon_intensity"], key=0, config=cfg)
              for pi, pm in ((40.0, 200.0), (80.0, 400.0)))
    assert hi.baseline.breakdown["gco2_kg"] > lo.baseline.breakdown["gco2_kg"]
