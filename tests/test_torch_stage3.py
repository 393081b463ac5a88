"""Stage 3 of the port against the JAX package: the searched what-if, the
resident DES and ``apply_proposal``, and the closed loop's leftovers.

``feedback.propose_from_optimum``, ``Orchestrator.optimize_whatif`` (JAX's
draws injected as in ``tests/test_torch_optimize.py``), the resident DES
(``TwinConfig.sim_bins``, ``TwinState.sim_u``, ``SimSlice(u_th=None)``),
``apply_proposal`` and ``_rebuild_state`` (the cases of
``tests/test_twin_core.py:386-631``), ``calibrate_window`` and
``SelfCalibrator`` (against JAX with its Pallas kernel in interpret mode,
and against the port's ``calibrate_traced``), ``metamodel`` and
``launch/twin.py`` on the CPU.  Bars: decision streams, proposals and
chosen grid points exact; twin float streams at rtol 5e-6; MAPEs of the
calibration kernels at rtol 1e-5 (``tests/test_torch_calibrate.py``'s).
"""

import dataclasses
import importlib
import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import feedback as jfb  # noqa: E402
from repro.core import metamodel as jmm  # noqa: E402
from repro.core import orchestrator as jorch  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.core.power import opendc_power as jopendc  # noqa: E402
from repro.core.scenarios import ScenarioSummary as JSummary  # noqa: E402
from repro.core.twin import TraceGroundTruth as JTraceGroundTruth  # noqa: E402
from repro.traces import schema as jschema  # noqa: E402
from repro.traces import surf as jsurf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import feedback as fb  # noqa: E402
from repro_torch.core import metamodel as mm  # noqa: E402
from repro_torch.core import orchestrator as porch  # noqa: E402
from repro_torch.core import state as pstate  # noqa: E402
from repro_torch.core.desim import simulate_utilization  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.core.scenarios import Scenario  # noqa: E402
from repro_torch.core.scenarios import ScenarioSummary  # noqa: E402
from repro_torch.core.twin import TraceGroundTruth, run_surf_experiment  # noqa: E402
from repro_torch.launch import twin as launch_twin  # noqa: E402
from repro_torch.traces import schema  # noqa: E402
from repro_torch.traces import surf  # noqa: E402
from test_torch_optimize import (  # noqa: E402
    JAX,
    JW,
    PORT,
    PW,
    TRACES,
    T_BINS,
    config,
    dc,
    inject_jax_draws,
    objective,
    sc_key,
    space,
)

popt = importlib.import_module("repro_torch.core.optimize")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWIN_RTOL = 5e-6
KERNEL_RTOL = 1e-5


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- propose_from_optimum -----------------------------------------------------

BASE_SUMMARY = dict(
    name="baseline", num_hosts=8, cores_per_host=4, policy="worst_fit", backfill_depth=0,
    mean_util=0.5, p99_queue=3.0, max_queue=5, mean_wait_bins=2.0, p99_wait_bins=8.0,
    unplaced_jobs=1, total_jobs=40, energy_kwh=100.0, mean_power_w=2000.0,
    peak_power_w=2600.0, peak_demand_w=2600.0, cpu_hours=300.0, kwh_per_cpu_hour=0.33,
    gco2=30000.0, carbon_intensity_avg=300.0, shift_bins=0, power_cap_w=None,
    carbon_cap_base_w=None, carbon_cap_slope=0.0, cap_exceeded_bins=0, mean_pue=None,
    energy_cost=12.0, failure_events=0)
BASE_BREAKDOWN = dict(gco2_kg=30.0, energy_kwh=100.0, energy_cost=12.0, total=40.0)

#: (summary overrides, objective, baseline objective, breakdown overrides)
OPTIMA = {
    "scheduler": (dict(name="bf", policy="best_fit", backfill_depth=4, mean_wait_bins=1.0),
                  38.0, 40.0, dict(total=38.0)),
    "same config": (dict(name="same"), 39.0, 40.0, dict(total=39.0)),
    "carbon fallback": (dict(name="shift", shift_bins=6, gco2=29800.0, num_hosts=9,
                             cores_per_host=8),
                        39.5, 40.0, dict(gco2_kg=29.8)),
    "cost fallback": (dict(name="capped", carbon_cap_base_w=1500.0, carbon_cap_slope=-2.0,
                           gco2=30100.0, energy_cost=11.9),
                      39.9, 40.0, dict(gco2_kg=30.1, energy_cost=11.9)),
    "cost absent": (dict(name="capped", power_cap_w=2500.0, energy_cost=None),
                    39.9, 40.0, dict(energy_cost=None)),
    "not improved": (dict(name="worse", shift_bins=3), 41.0, 40.0, dict()),
    "infinite": (dict(name="inf", shift_bins=3), math.inf, 40.0, dict()),
    "cap runs into demand": (dict(name="cap", power_cap_w=2400.0, cap_exceeded_bins=7,
                                  gco2=25000.0, energy_kwh=99.0),
                             30.0, 40.0, dict(gco2_kg=25.0)),
    "scale down": (dict(name="h6", num_hosts=6, energy_kwh=90.0, unplaced_jobs=1),
                   35.0, 40.0, dict()),
}


def proposals_of(m_fb, m_summary, case):
    over, obj, base_obj, bd = OPTIMA[case]
    base = m_summary(**BASE_SUMMARY)
    summ = m_summary(**{**BASE_SUMMARY, **over})
    props = m_fb.propose_from_optimum(
        7, summ, base, objective=obj, baseline_objective=base_obj,
        breakdown={**BASE_BREAKDOWN, **bd}, baseline_breakdown=dict(BASE_BREAKDOWN))
    return [(p.kind.value, p.window, p.detail, p.impact) for p in props]


@pytest.mark.parametrize("case", list(OPTIMA))
def test_propose_from_optimum_matches_jax(case):
    want = proposals_of(jfb, JSummary, case)
    got = proposals_of(fb, ScenarioSummary, case)
    assert got == want
    kinds = [k for k, *_ in got]
    if case in ("same config", "not improved", "infinite"):
        assert "carbon_reduction" not in kinds and "cost_reduction" not in kinds
    if case == "carbon fallback":
        assert kinds == ["carbon_reduction"]
    if case == "cost fallback":
        assert kinds == ["cost_reduction"]


# -- optimize_whatif ----------------------------------------------------------

def whatif_orchs(with_carbon=True):
    traces = dict(carbon_intensity=TRACES["carbon_intensity"]) if with_carbon else {}
    jo = jorch.Orchestrator(JW, dc(JAX), T_BINS, jorch.OrchestratorConfig(
        bins_per_window=24, calibrate=False), **traces)
    po = porch.Orchestrator(PW, dc(PORT), T_BINS, porch.OrchestratorConfig(
        bins_per_window=24, calibrate=False, device="cpu"), **traces)
    return jo, po


def same_gate(jres, pres, jo, po):
    assert [(p.kind.value, p.window, p.impact["searched_optimum"]) for p in pres.proposals] \
        == [(p.kind.value, p.window, p.impact["searched_optimum"]) for p in jres.proposals]
    for a, b in zip(pres.proposals, jres.proposals):
        assert a.impact["objective"] == pytest.approx(b.impact["objective"], rel=TWIN_RTOL)
        assert a.impact["objective_baseline"] == pytest.approx(
            b.impact["objective_baseline"], rel=TWIN_RTOL)
    assert len(po.gate.pending()) == len(jo.gate.pending())
    got, want = pres.result, jres.result
    assert [sc_key(c.scenario) for c in got.history] == \
        [sc_key(c.scenario) for c in want.history]
    np.testing.assert_allclose([c.objective for c in got.history],
                               [c.objective for c in want.history], rtol=TWIN_RTOL)
    assert sc_key(got.best.scenario) == sc_key(want.best.scenario)


def test_optimize_whatif_routes_the_optimum_through_the_gate_as_jax(monkeypatch):
    inject_jax_draws(monkeypatch)
    jo, po = whatif_orchs()
    jres = jo.optimize_whatif(space(JAX), objective(JAX), key=0, config=config(JAX))
    pres = po.optimize_whatif(space(PORT), objective(PORT), key=0, config=config(PORT))
    same_gate(jres, pres, jo, po)
    assert pres.proposals
    for p in pres.proposals:
        assert p.impact["objective"] == pres.result.best.objective
        assert p.impact["objective_breakdown"]["total"] == pytest.approx(
            pres.result.best.breakdown["total"])
        assert p.impact["searched_optimum"] == pres.result.best.scenario.name


def test_optimize_whatif_default_space_without_carbon_as_jax(monkeypatch):
    inject_jax_draws(monkeypatch)
    jo, po = whatif_orchs(with_carbon=False)
    jres = jo.optimize_whatif(config=config(JAX, generations=1))
    pres = po.optimize_whatif(config=config(PORT, generations=1))
    same_gate(jres, pres, jo, po)
    assert math.isnan(pres.result.best.breakdown["gco2_kg"])
    assert [sc_key(s) for s in po.default_search_space().structures] == \
        [sc_key(s) for s in jo.default_search_space().structures]
    assert {s.policy for s in po.default_search_space().structures} == {
        "best_fit", "first_fit", "random_fit", "worst_fit"}


def test_optimize_whatif_uses_the_calibrated_parameters(monkeypatch):
    """The search prices lanes with ``state.params``, the twin's calibrated
    parameters on its device, not the constructor's base."""
    _, po = whatif_orchs()
    po.state = dataclasses.replace(po.state, params=PowerParams(
        p_idle=torch.tensor(120.0), p_max=torch.tensor(500.0), r=torch.tensor(2.0)))
    sp = popt.SearchSpace(structures=(Scenario(name="wf"),), shift_bins=(0, 6))
    hot = po.optimize_whatif(sp, objective(PORT), config=config(PORT, generations=0,
                                                                batch_size=4))
    _, cold = whatif_orchs()
    cool = cold.optimize_whatif(sp, objective(PORT), config=config(PORT, generations=0,
                                                                   batch_size=4))
    assert hot.result.baseline.breakdown["gco2_kg"] > cool.result.baseline.breakdown["gco2_kg"]


# -- the resident DES ---------------------------------------------------------

JDC_SMALL = jschema.DatacenterConfig(num_hosts=8, cores_per_host=4)
DC_SMALL = schema.DatacenterConfig(num_hosts=8, cores_per_host=4)


def _telem(seed):
    """``tests/test_twin_core.py:143``'s window telemetry."""
    r = np.random.default_rng(seed)
    u = r.uniform(0, 1, (12, 8)).astype(np.float32)
    p = (8 * 70 + 2240 * r.uniform(0.2, 0.9, 12)).astype(np.float32)
    return u, p


def assert_outputs(got, want, exact=False):
    """Two WindowOutputs: decisions exact, floats at the twin's bar (or
    bitwise with ``exact``)."""
    for f in ("p_idle", "p_max", "r"):
        for which in ("params_used", "params_next"):
            np.testing.assert_array_equal(as_np(getattr(getattr(got, which), f)),
                                          as_np(getattr(getattr(want, which), f)))
    assert int(got.window) == int(want.window)
    pairs = [(got.mape, want.mape), (got.calib_mape, want.calib_mape),
             (got.prediction.power_w, want.prediction.power_w),
             (got.prediction.energy_kwh, want.prediction.energy_kwh)]
    for a, b in pairs:
        if exact:
            np.testing.assert_array_equal(as_np(a), as_np(b))
        else:
            np.testing.assert_allclose(as_np(a), as_np(b), rtol=TWIN_RTOL)


def test_resident_des_slices_its_own_window_as_jax():
    """``tests/test_twin_core.py:386``: with ``sim_bins > 0`` and
    ``SimSlice(u_th=None)`` the step reads the window's slice of
    ``state.sim_u``, bitwise the explicit slice's outputs; a window past the
    field clamps to its last slice as ``lax.dynamic_slice`` does; JAX's
    resident step agrees."""
    sim_u = np.random.default_rng(21).uniform(0, 1, (36, 8)).astype(np.float32)
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, sim_bins=36)
    cfg = pstate.TwinConfig(bins_per_window=12, dc=DC_SMALL, sim_bins=36, device="cpu")
    ext = pstate.init_twin_state(dataclasses.replace(cfg, sim_bins=0))
    res = pstate.init_twin_state(cfg, sim_u=sim_u)
    jres = jstate.init_twin_state(jcfg, sim_u=sim_u)
    step = jax.jit(jstate.twin_step)
    for w in range(4):
        u, p = _telem(w)
        window_u = sim_u[12 * min(w, 2):12 * (min(w, 2) + 1)]
        ext, out_e = pstate.twin_step(ext, pstate.make_telemetry(u, p, device="cpu"),
                                      pstate.SimSlice(u_th=torch.from_numpy(window_u)))
        res, out_r = pstate.twin_step(res, pstate.make_telemetry(u, p, device="cpu"),
                                      pstate.SimSlice())
        jres, out_j = step(jres, jstate.make_telemetry(u, p), jstate.SimSlice())
        assert_outputs(out_r, out_e, exact=True)
        assert_outputs(out_r, out_j)
    np.testing.assert_array_equal(res.sim_u.numpy(), sim_u)


@pytest.mark.parametrize("case", ["no u_th and no sim_u", "short sim_u", "sim_u, no bins"])
def test_resident_des_rejects_as_jax(case):
    msgs = []
    for st, cfg_cls, dc_, extra in ((jstate, jstate.TwinConfig, JDC_SMALL, {}),
                                    (pstate, pstate.TwinConfig, DC_SMALL,
                                     dict(device="cpu"))):
        cfg = cfg_cls(bins_per_window=12, dc=dc_, **extra)
        with pytest.raises(ValueError) as e:
            if case == "no u_th and no sim_u":
                u, p = _telem(0)
                tel = (st.make_telemetry(u, p, device="cpu") if st is pstate
                       else st.make_telemetry(u, p))
                st.twin_step(st.init_twin_state(cfg), tel, st.SimSlice())
            elif case == "short sim_u":
                st.init_twin_state(dataclasses.replace(cfg, sim_bins=36),
                                   sim_u=np.zeros((24, 8), np.float32))
            else:
                st.init_twin_state(cfg, sim_u=np.zeros((36, 8), np.float32))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_state_from_numpy_carries_the_resident_field():
    """``convert.twin_state_from_numpy`` takes a resident state's 19th leaf,
    ``sim_u``, and the converted state steps like JAX's."""
    sim_u = np.random.default_rng(8).uniform(0, 1, (24, 8)).astype(np.float32)
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, sim_bins=24)
    jst = jstate.init_twin_state(jcfg, sim_u=sim_u)
    u, p = _telem(2)
    jst, _ = jax.jit(jstate.twin_step)(jst, jstate.make_telemetry(u, p), jstate.SimSlice())
    leaves = jax.tree_util.tree_leaves(jst)
    assert len(leaves) == 19
    cfg = pstate.TwinConfig(bins_per_window=12, dc=DC_SMALL, sim_bins=24, device="cpu")
    st = convert.twin_state_from_numpy(leaves, cfg)
    np.testing.assert_array_equal(st.sim_u.numpy(), sim_u)
    assert int(st.window) == 1 and int(st.hist_n) == 1
    u, p = _telem(3)
    _, out = pstate.twin_step(st, pstate.make_telemetry(u, p, device="cpu"), pstate.SimSlice())
    _, jout = jax.jit(jstate.twin_step)(jst, jstate.make_telemetry(u, p), jstate.SimSlice())
    assert_outputs(out, jout)
    with pytest.raises(ValueError, match="expected 18"):
        convert.twin_state_from_numpy(leaves, dataclasses.replace(cfg, sim_bins=0))
    with pytest.raises(ValueError, match=r"sim_u must be \[36, 8\]"):
        convert.twin_state_from_numpy(leaves, dataclasses.replace(cfg, sim_bins=36))


# -- the orchestrator: resident DES, apply_proposal ----------------------------

def orch_pair(cfg_kw, days=0.5, seed=3, hosts=8, base=None, per_host=False):
    if per_host:
        cfg_kw = (dict(cfg_kw, calibration=jcal.CalibrationSpec(per_host=True)),
                  dict(cfg_kw, calibration=cal.CalibrationSpec(per_host=True)))
    else:
        cfg_kw = (cfg_kw, cfg_kw)
    jdc = jschema.DatacenterConfig(num_hosts=hosts, cores_per_host=4)
    pdc = schema.DatacenterConfig(num_hosts=hosts, cores_per_host=4)
    jw = jsurf.make_surf22_like(jsurf.SurfTraceSpec(days=days, seed=seed), jdc)
    pw = surf.make_surf22_like(surf.SurfTraceSpec(days=days, seed=seed), pdc, device="cpu")
    t_bins = int(days * jsurf.BINS_PER_DAY)
    jb = JPowerParams() if base is None else JPowerParams(**base)
    pb = PowerParams() if base is None else PowerParams(**base)
    jo = jorch.Orchestrator(jw, jdc, t_bins, jorch.OrchestratorConfig(
        bins_per_window=12, **cfg_kw[0]), base_params=jb)
    po = porch.Orchestrator(pw, pdc, t_bins, porch.OrchestratorConfig(
        bins_per_window=12, device="cpu", **cfg_kw[1]), base_params=pb)
    truths = (JTraceGroundTruth(jw, jdc, t_bins), TraceGroundTruth(pw, pdc, t_bins))
    return (jo, po), truths


def run_windows(orchs, truths, windows):
    for o, tr in zip(orchs, truths):
        for win in windows:
            o.store.ingest(tr.window(win, 12))
            o.run_window(win)


def assert_records(got, want, exact=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("p_idle", "p_max", "r"):
            np.testing.assert_array_equal(as_np(getattr(a.params, f)),
                                          as_np(getattr(b.params, f)))
        assert (a.mape is None) == (b.mape is None) and a.proposals == b.proposals
        pa, pb_ = as_np(a.prediction.power_w), as_np(b.prediction.power_w)
        if exact:
            np.testing.assert_array_equal(pa, pb_)
            assert a.mape == b.mape
        else:
            np.testing.assert_allclose(pa, pb_, rtol=TWIN_RTOL)
            if b.mape is not None:
                assert a.mape == pytest.approx(b.mape, rel=TWIN_RTOL)


def test_resident_orchestrator_equals_the_external_cache_and_jax():
    """``tests/test_twin_core.py:505``: resident-DES mode is plumbing only,
    window for window bitwise in the port, and JAX's resident run agrees."""
    (jo, po), truths = orch_pair(dict(sim_in_state=True))
    (_, ext), _ = orch_pair({})
    run_windows((jo, po), truths, range(po.num_windows))
    run_windows((ext,), truths[1:], range(ext.num_windows))
    assert po.state.sim_u is not None and ext.state.sim_u is None
    np.testing.assert_array_equal(po.state.sim_u.numpy(), ext._ensure_sim().u_th.numpy())
    assert_records(po.records, ext.records, exact=True)
    assert_records(po.records, jo.records)
    np.testing.assert_allclose(po.state.sim_u.numpy(), np.asarray(jo.state.sim_u),
                               rtol=TWIN_RTOL)


def test_ensure_sim_runs_the_twins_scheduler():
    """The DES behind the twin runs ``policy``/``backfill_depth``: set on the
    orchestrator, they reach ``simulate_utilization`` (and change the
    placement on this trace)."""
    (_, po), _ = orch_pair({}, hosts=4)
    default = po._ensure_sim().job_host.clone()
    po.policy, po.backfill_depth = "best_fit", 4
    po.invalidate()
    got = po._ensure_sim()
    want = simulate_utilization(po.workload, num_hosts=4, cores_per_host=4,
                                t_bins=po.t_bins, policy="best_fit", backfill_depth=4)
    for k in ("job_start", "job_host", "queue_len", "running", "u_th"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert not torch.equal(got.job_host, default)


def scheduler_proposal(m_fb, policy="best_fit", depth=4):
    return m_fb.Proposal(
        kind=m_fb.ProposalKind.SCHEDULER_CHANGE, window=4, detail="bf",
        impact={"scenario": "s", "policy": policy, "backfill_depth": depth,
                "mean_wait_bins": 0.0, "unplaced_jobs": 0, "energy_kwh": 1.0},
        created_at=0.0, approved=True)


def test_scheduler_change_keeps_the_history_and_matches_jax_mid_run():
    """``tests/test_twin_core.py:554`` with the change applied mid-run: the
    calibration history survives, the resident DES is re-run under the new
    scheduler (equal to a plain ``simulate_utilization`` under it), and the
    remaining windows match JAX's."""
    (jo, po), truths = orch_pair(dict(sim_in_state=True), hosts=4)
    run_windows((jo, po), truths, range(6))
    hist = int(po.state.hist_n)
    for o, m_fb in ((jo, jfb), (po, fb)):
        p = scheduler_proposal(m_fb)
        o.apply_proposal(p)
        assert p.applied and o.policy == "best_fit" and o.backfill_depth == 4
    assert int(po.state.hist_n) == hist == int(jo.state.hist_n)
    want = simulate_utilization(po.workload, num_hosts=4, cores_per_host=4,
                                t_bins=po.t_bins, policy="best_fit", backfill_depth=4)
    assert torch.equal(po.state.sim_u, want.u_th)
    np.testing.assert_allclose(po.state.sim_u.numpy(), np.asarray(jo.state.sim_u),
                               rtol=TWIN_RTOL)
    run_windows((jo, po), truths, range(6, po.num_windows))
    assert_records(po.records, jo.records)
    rec, jrec = po.run_window(0), jo.run_window(0)     # past the end: clamped
    np.testing.assert_allclose(rec.prediction.power_w.numpy(),
                               np.asarray(jrec.prediction.power_w), rtol=TWIN_RTOL)


def test_scale_up_reseeds_the_resident_des_as_jax():
    """``tests/test_twin_core.py:519``: the topology grows, the run's
    accumulators migrate, the history restarts, stale telemetry scores
    nothing."""
    (jo, po), truths = orch_pair(dict(sim_in_state=True))
    run_windows((jo, po), truths, range(po.num_windows))
    slo = po.state.slo_samples.clone()
    for o, m_fb in ((jo, jfb), (po, fb)):
        p = m_fb.Proposal(kind=m_fb.ProposalKind.SCALE_UP, window=3, detail="grow",
                          impact={"num_hosts": 12}, created_at=0.0)
        with pytest.raises(ValueError, match="not approved"):
            o.apply_proposal(p)
        p.approved = True
        o.apply_proposal(p)
        assert p.applied and o.dc.num_hosts == 12 and o.state.cfg.dc.num_hosts == 12
    assert tuple(po.state.sim_u.shape) == (po.t_bins, 12)
    assert int(po.state.window) == po.num_windows == int(jo.state.window)
    assert torch.equal(po.state.slo_samples, slo)
    assert int(po.state.hist_n) == 0 == int(jo.state.hist_n)
    for f in ("p_idle", "p_max", "r"):
        np.testing.assert_array_equal(as_np(getattr(po.state.params, f)),
                                      as_np(getattr(jo.state.params, f)))
        np.testing.assert_array_equal(as_np(getattr(po.state.cand, f)),
                                      as_np(getattr(jo.state.cand, f)))
    want = simulate_utilization(po.workload, num_hosts=12, cores_per_host=4, t_bins=po.t_bins)
    assert torch.equal(po.state.sim_u, want.u_th)
    np.testing.assert_allclose(po.state.sim_u.numpy(), np.asarray(jo.state.sim_u),
                               rtol=TWIN_RTOL)
    rec, jrec = po.run_window(0), jo.run_window(0)
    assert rec.mape is None and jrec.mape is None
    assert np.isfinite(rec.prediction.power_w.numpy()).all()
    np.testing.assert_allclose(rec.prediction.power_w.numpy(),
                               np.asarray(jrec.prediction.power_w), rtol=TWIN_RTOL)


@pytest.mark.parametrize("case", ["power cap", "unapproved", "no num_hosts", "zero hosts"])
def test_apply_proposal_rejects_as_jax(case):
    (jo, po), _ = orch_pair({}, days=0.25)
    msgs = []
    for o, m_fb in ((jo, jfb), (po, fb)):
        kind, impact, approved = {
            "power cap": ("POWER_CAP", {}, True),
            "unapproved": ("SCALE_DOWN_IDLE", {"num_hosts": 4}, None),
            "no num_hosts": ("SCALE_DOWN_IDLE", {}, True),
            "zero hosts": ("SCALE_UP", {"num_hosts": 0}, True)}[case]
        p = m_fb.Proposal(kind=getattr(m_fb.ProposalKind, kind), window=1, detail="x",
                          impact=impact, created_at=0.0, approved=approved)
        with pytest.raises(ValueError) as e:
            o.apply_proposal(p)
        assert not p.applied
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("hosts", [12, 5])
def test_per_host_rows_migrate_as_jax(hosts):
    """``tests/test_twin_core.py:589``: rows survive, growth takes the rows'
    mean; a shrink keeps the first rows."""
    base = dict(p_idle=np.arange(8, dtype=np.float32) + 60.0, p_max=350.0, r=2.0)
    (jo, po), _ = orch_pair(dict(sim_in_state=True), days=0.25, base=base, per_host=True)
    for o, m_fb in ((jo, jfb), (po, fb)):
        kind = "SCALE_UP" if hosts > 8 else "SCALE_DOWN_IDLE"
        o.apply_proposal(m_fb.Proposal(
            kind=getattr(m_fb.ProposalKind, kind), window=0, detail="resize",
            impact={"num_hosts": hosts}, created_at=0.0, approved=True))
    for f in ("p_idle", "p_max", "r"):
        rows = getattr(po.state.params, f).numpy()
        assert rows.shape == (hosts,)
        np.testing.assert_array_equal(rows, np.asarray(getattr(jo.state.params, f)))
    rows = po.state.params.p_idle.numpy()
    np.testing.assert_array_equal(rows[:min(8, hosts)],
                                  np.arange(min(8, hosts), dtype=np.float32) + 60.0)
    if hosts > 8:
        np.testing.assert_array_equal(rows[8:], np.full(hosts - 8, 63.5, np.float32))
    assert tuple(po.state.sim_u.shape) == (po.t_bins, hosts)


# -- calibrate_window and SelfCalibrator ---------------------------------------

BASE = (70.0, 350.0, 2.0)


def _window(seed, t=96, h=16, noise=0.01):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.05, 0.95, (t, h)).astype(np.float32)
    r = float(rng.uniform(1.5, 4.5))
    p = np.asarray(jopendc(jnp.asarray(u), JPowerParams(75.0, 360.0, r))).sum(1)
    return u, (p * (1.0 + noise * rng.standard_normal(t))).astype(np.float32)


def _params(p):
    return tuple(float(np.asarray(getattr(p, f))) for f in ("p_idle", "p_max", "r"))


def _objective(u, real, p):
    return float(cal.mape(torch.from_numpy(real),
                          cal.opendc_power(torch.from_numpy(u), p).sum(-1)))


WINDOWS = {
    "r_only": (0, dict(r_points=32)),
    "joint": (1, dict(mode="joint", r_points=16, scale_points=5)),
    "r_only refined": (2, dict(r_points=16, refine_iters=2)),
    "joint refined": (3, dict(mode="joint", r_points=12, scale_points=4, refine_iters=2)),
    "all zero": (4, dict(mode="joint", r_points=8, scale_points=3, refine_iters=2)),
    "one finite bin": (5, dict(r_points=16, refine_iters=2)),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_calibrate_window_matches_jax_and_the_traced_cycle(case):
    seed, kw = WINDOWS[case]
    u, real = _window(seed)
    if case == "all zero":
        real = np.zeros_like(real)
    elif case == "one finite bin":
        real = np.where(np.arange(real.size) == 7, real, 0.0).astype(np.float32)
    want = jcal.calibrate_window(jnp.asarray(u), jnp.asarray(real), jcal.CalibrationSpec(**kw),
                                 JPowerParams(*BASE), backend="pallas_interpret")
    spec, base = cal.CalibrationSpec(**kw), PowerParams(*BASE)
    got = cal.calibrate_window(torch.from_numpy(u), torch.from_numpy(real), spec, base)
    assert got.evaluated == want.evaluated
    assert got.mapes.shape == want.mapes.shape
    if case == "all zero":
        assert got.params is base and math.isnan(got.mape) and math.isnan(want.mape)
        assert np.isnan(got.mapes).all()
        return
    assert _params(got.params) == _params(want.params)
    assert got.mape == pytest.approx(want.mape, rel=KERNEL_RTOL)
    np.testing.assert_allclose(got.mapes, want.mapes, rtol=KERNEL_RTOL, atol=1e-6)
    # the port's own traced cycle lands on the same operating point
    t_params, t_mape = cal.calibrate_traced(
        torch.from_numpy(u), torch.from_numpy(real),
        cal.candidate_grid(spec, base, device="cpu"), spec, base)
    if spec.refine_iters == 0:
        assert _params(t_params) == _params(got.params)
        assert float(t_mape) == got.mape
    else:
        assert _objective(u, real, t_params) == pytest.approx(
            _objective(u, real, got.params), rel=1e-3, abs=1e-3)


def test_calibrate_window_needs_a_tensor():
    u, real = _window(0)
    with pytest.raises(TypeError, match="torch.Tensor"):
        cal.calibrate_window(u, real, cal.CalibrationSpec(), PowerParams(*BASE))


def test_self_calibrator_pipelines_as_jax():
    jcalib = jcal.SelfCalibrator(jcal.CalibrationSpec(r_points=24), JPowerParams(*BASE),
                                 history_windows=2)
    pcalib = cal.SelfCalibrator(cal.CalibrationSpec(r_points=24), PowerParams(*BASE),
                                device="cpu", history_windows=2)
    assert _params(pcalib.params_for_next()) == BASE
    for seed in range(4):
        u, real = _window(10 + seed, t=36)
        if seed == 2:
            real = np.zeros_like(real)             # a window with no power
        want = jcalib.observe(u, real)
        got = pcalib.observe(torch.from_numpy(u) if seed % 2 else u, real)
        assert _params(pcalib.params_for_next()) == _params(jcalib.params_for_next())
        assert got.mape == pytest.approx(want.mape, rel=KERNEL_RTOL)
        assert len(pcalib._u) == min(seed + 1, 2)
    assert len(pcalib.history) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cal.SelfCalibrator(cal.CalibrationSpec(), PowerParams())


# -- the multi-model combiner -------------------------------------------------

@pytest.mark.parametrize("per_host", [False, True])
def test_multi_model_matches_jax(per_host):
    rng = np.random.default_rng(6)
    u = rng.uniform(0.0, 1.0, (48, 16)).astype(np.float32)
    if per_host:
        kw = dict(p_idle=rng.uniform(60, 90, 16).astype(np.float32),
                  p_max=rng.uniform(300, 400, 16).astype(np.float32), r=2.4)
    else:
        kw = dict(p_idle=65.0, p_max=330.0, r=2.7)
    want = jmm.run_multi_model(jnp.asarray(u), JPowerParams(**kw))
    got = mm.run_multi_model(torch.from_numpy(u), PowerParams(**kw))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=TWIN_RTOL)
    reference = (want["opendc"] * (1 + 0.05 * rng.standard_normal(48))).astype(np.float64)
    for how in ("mean", "median", "inv_mape"):
        a = mm.combine(got, how, reference=reference)
        b = jmm.combine(want, how, reference=reference)
        np.testing.assert_allclose(a.combined, b.combined, rtol=TWIN_RTOL)
        assert list(a.weights) == list(b.weights)
        np.testing.assert_allclose(list(a.weights.values()), list(b.weights.values()),
                                   rtol=TWIN_RTOL)
    msgs = []
    for m, pm in ((jmm, want), (mm, got)):
        for call in (lambda: m.combine(pm, "inv_mape"), lambda: m.combine(pm, "mode")):
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


# -- launch/twin.py -----------------------------------------------------------

def test_launch_twin_on_the_cpu_equals_run_surf_experiment(capsys):
    res = launch_twin.main(["--device", "cpu", "--days", "0.5"])
    out = capsys.readouterr().out
    dc_ = schema.DatacenterConfig()
    w = surf.make_surf22_like(surf.SurfTraceSpec(days=0.5, seed=22), dc_, device="cpu")
    want = run_surf_experiment(w, dc_, 144, calibrate=True,
                               cfg=porch.OrchestratorConfig(device="cpu"))
    assert res.overall_mape == want.overall_mape
    np.testing.assert_array_equal(res.per_window_mape, want.per_window_mape)
    assert f"overall MAPE: {want.overall_mape:.2f}%" in out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.twin", "--device", "cpu",
                          "--days", "0.5"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert run.returncode == 0, run.stderr
    assert re.search(rf"overall MAPE: {want.overall_mape:.2f}%", run.stdout)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch_twin.main(["--days", "0.5"])
