"""The port's scenario-axis sharding: a what-if batch split over a mesh
equals the unsharded batch bit for bit, and the JAX package's vmap path at
the parity bars.

Mirrors ``tests/test_shard_scenarios.py`` case for case, at its sizes (32
hosts x 16 cores, a quarter day of bins, the JAX trace generator's
workload carried into the port), on CPU meshes of 1, 3 and 4 entries:
``run_scenarios`` with and without carbon and on the failure, PUE, price
and ambient axes, padding when S is not a multiple of the entries, one
lane an entry with backfill, ``evaluate_scenarios``, ``optimize`` and
``Orchestrator.optimize_whatif``; sharded against unsharded with
``torch.equal`` on every leaf and equal summaries, and against the JAX
package's default path with schedules exact, floats at rtol 5e-6 and the
search's decisions exact (its draws injected).  Every entry's placement
is called before the first read-out.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as jsc  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.traces import schema as jschema  # noqa: E402
from repro.traces.carbon import make_diurnal_carbon  # noqa: E402
from repro.traces.price import make_diurnal_price  # noqa: E402
from repro.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like  # noqa: E402
from repro.traces.thermal import make_diurnal_ambient  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import desim  # noqa: E402
from repro_torch.core import orchestrator as porch  # noqa: E402
from repro_torch.core import scenarios as psc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.traces import schema  # noqa: E402
from test_torch_optimize import assert_same_search, inject_jax_draws  # noqa: E402
from test_torch_scenarios import assert_pred, assert_sim, assert_summaries  # noqa: E402

jopt = importlib.import_module("repro.core.optimize")
popt = importlib.import_module("repro_torch.core.optimize")

T_BINS = int(0.25 * BINS_PER_DAY)
DC = schema.DatacenterConfig(num_hosts=32, cores_per_host=16)
JDC = jschema.DatacenterConfig(num_hosts=32, cores_per_host=16)
JW = make_surf22_like(SurfTraceSpec(days=0.25, seed=5), JDC)
PW = convert.workload_from_numpy(JW, device="cpu")
CI = make_diurnal_carbon(T_BINS, seed=1)
ENTRIES = (1, 3, 4)


def _grid(sc):
    """S=6: not a multiple of 4 entries, so 4 pads (and 3 does not)."""
    return [
        sc.Scenario(name="base"),
        sc.Scenario(name="h16-bf", num_hosts=16, policy="best_fit", backfill_depth=2),
        sc.Scenario(name="h24-ff", num_hosts=24, policy="first_fit"),
        sc.Scenario(name="cap", power_cap_w=5000.0),
        sc.Scenario(name="shift", shift_bins=6),
        sc.Scenario(name="cc", carbon_cap_base_w=7000.0, carbon_cap_slope=-5.0),
    ]


def _new_axes(sc, hf, outage, degraded):
    return [
        sc.Scenario(name="base"),
        sc.Scenario(name="outage", failures=(
            hf(host=3, start_bin=4, end_bin=24, kind=outage),
            hf(host=7, start_bin=10, end_bin=40, kind=degraded))),
        sc.Scenario(name="pue", pue_base=1.2, pue_amb_coeff=0.02, pue_load_coeff=0.15),
        sc.Scenario(name="mix", power_cap_w=6000.0, shift_bins=4, backfill_depth=2,
                    pue_base=1.1, pue_load_coeff=0.05,
                    failures=(hf(host=0, start_bin=8, end_bin=16, kind=outage),)),
        sc.Scenario(name="cc-pue", carbon_cap_base_w=7000.0, carbon_cap_slope=-5.0,
                    pue_base=1.3),
    ]


NEW_AXIS_TRACES = dict(carbon_intensity=CI, ambient_c=make_diurnal_ambient(T_BINS, seed=2),
                       price=make_diurnal_price(T_BINS, seed=3))

CASES = {
    "carbon": (lambda sc: _grid(sc), dict(carbon_intensity=CI)),
    "no carbon": (lambda sc: _grid(sc)[:4], dict()),
    "padding": (lambda sc: _grid(sc)[:5], dict()),
    "new axes": (lambda sc: _new_axes(sc, *((jfault.HostFailure, jfault.OUTAGE,
                                             jfault.DEGRADED) if sc is jsc else
                                            (fault.HostFailure, fault.OUTAGE,
                                             fault.DEGRADED))),
                 NEW_AXIS_TRACES),
}


def _mesh(n: int):
    return psc.scenario_mesh(n, device="cpu")


def _run(case: str, **kw):
    scs, traces = CASES[case]
    ss = psc.build_scenario_set(PW, DC, scs(psc))
    return ss, psc.run_scenarios(ss, max_hosts=ss.max_hosts, t_bins=T_BINS, **traces, **kw)


@functools.lru_cache(maxsize=None)
def _unsharded(case: str):
    return _run(case)


@functools.lru_cache(maxsize=None)
def _jax(case: str):
    scs, traces = CASES[case]
    ss = jsc.build_scenario_set(JW, JDC, scs(jsc))
    sim, pred = jsc.run_scenarios(ss, max_hosts=ss.max_hosts, t_bins=T_BINS, **traces)
    return sim, pred, jsc.summarize_scenarios(ss, sim, pred,
                                              carbon_intensity=traces.get("carbon_intensity"))


def _assert_bitwise(a, b):
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            assert (u is None) == (v is None), f.name
            if u is not None:
                assert u.dtype == v.dtype and u.device == v.device, f.name
                assert torch.equal(u, v), f.name


def _same_summaries(a, b):
    """Field for field equal, NaN where NaN."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f, u in x.__dict__.items():
            v = y.__dict__[f]
            assert u == v or (u != u and v != v), (x.name, f, u, v)


def _check(case: str, n: int):
    """Sharded over ``n`` entries: bit for bit the unsharded batch, the same
    summaries, and the JAX package's batch at the parity bars."""
    traces = CASES[case][1]
    ss, ref = _unsharded(case)
    _, sh = _run(case, shard=True, mesh=_mesh(n))
    assert sh[0].u_th.shape[0] == ss.num_scenarios
    _assert_bitwise(ref, sh)
    ci = traces.get("carbon_intensity")
    got = psc.summarize_scenarios(ss, *sh, carbon_intensity=ci)
    _same_summaries(got, psc.summarize_scenarios(ss, *ref, carbon_intensity=ci))
    jsim, jpred, jsum = _jax(case)
    assert_sim(sh[0], jsim)
    assert_pred(sh[1], jpred, 5e-6)
    assert_summaries(got, jsum)
    return got


@pytest.mark.parametrize("n", ENTRIES)
def test_sharded_matches_unsharded_bitwise(n):
    _check("carbon", n)


@pytest.mark.parametrize("n", ENTRIES)
def test_sharded_matches_unsharded_without_carbon(n):
    """The no-intensity path (``gco2`` absent)."""
    _check("no carbon", n)


@pytest.mark.parametrize("n", ENTRIES)
def test_explicit_mesh_and_padding(n):
    """S=5 pads on 3 and 4 entries with scenario-0 replicas named ``""``;
    the outputs come back with the true S."""
    mesh = _mesh(n)
    assert mesh.shape[psc.SCENARIO_AXIS] == n
    _check("padding", n)
    _, (sim, pred) = _run("padding", shard=True, mesh=mesh)
    assert tuple(pred.power_w.shape) == (5, T_BINS)


@pytest.mark.parametrize("n", ENTRIES)
def test_sharded_matches_unsharded_new_axes(n):
    """Failure windows, dynamic PUE with ambient, spot price and carbon:
    the ``[T]`` traces go whole to every entry, the per-host failure arrays
    and PUE fields split with their lanes."""
    summ = _check("new axes", n)
    assert summ[1].failure_events == 2
    assert summ[2].mean_pue is not None and summ[2].mean_pue > 1.0
    assert all(s.energy_cost is not None and s.energy_cost > 0 for s in summ)


@pytest.mark.parametrize("n", ENTRIES)
@pytest.mark.parametrize("fused", [False, True])
def test_one_lane_per_entry_with_backfill(n, fused):
    """S equal to the entries with backfill in one lane (each entry padded
    to 2 lanes when there is more than one), unfused and fused readout."""
    scs = [psc.Scenario(name=f"s{i}", num_hosts=16 + 2 * i,
                        backfill_depth=2 if i == 1 else 0) for i in range(n)]
    ss = psc.build_scenario_set(PW, DC, scs)
    kw = dict(max_hosts=ss.max_hosts, t_bins=T_BINS, fused_readout=fused)
    _assert_bitwise(psc.run_scenarios(ss, **kw),
                    psc.run_scenarios(ss, **kw, shard=True, mesh=_mesh(n)))


def test_lanes_split_and_every_placement_comes_first(monkeypatch):
    """On 4 entries S=6 runs as four shards of 2 lanes: one placement and
    one fused readout call an entry, and every entry's placement is called
    before the first read of the host (the schedule's job table)."""
    order = []

    def traced(name, fn):
        def wrapper(*a, **kw):
            order.append((name, a[0].shape[0]))
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(ops, "des_place", traced("place", ops.des_place))
    monkeypatch.setattr(ops, "des_readout", traced("readout", ops.des_readout))
    monkeypatch.setattr(desim, "_job_table", traced("host read", desim._job_table))
    _run("carbon", shard=True, mesh=_mesh(4), fused_readout=True)
    assert order[:4] == [("place", 2)] * 4
    assert [o for o in order if o[0] != "host read"] == [("place", 2)] * 4 + [("readout", 2)] * 4
    assert sum(o[0] == "host read" for o in order) == 4


def test_evaluate_scenarios_sharded_matches_unsharded():
    ref = psc.evaluate_scenarios(PW, DC, _grid(psc), t_bins=T_BINS, carbon_intensity=CI)
    sh = psc.evaluate_scenarios(PW, DC, _grid(psc), t_bins=T_BINS, carbon_intensity=CI,
                                shard=True, mesh=_mesh(4))
    _assert_bitwise(ref[1:3], sh[1:3])
    _same_summaries(ref[3], sh[3])


def _search(m, **kw):
    space = m.opt.SearchSpace(
        structures=(m.Scenario(name="wf"),
                    m.Scenario(name="bf", policy="best_fit", backfill_depth=2)),
        carbon_cap_base_w=(1500.0, 4000.0), shift_bins=(0, 8))
    obj = m.opt.ObjectiveSpec(w_gco2_kg=1.0, w_wait=0.1, w_unplaced=10.0)
    cfg = m.opt.OptimizerConfig(batch_size=8, generations=2, init="grid", init_levels=2)
    return m.opt.optimize(m.w, m.dc, space, obj, t_bins=T_BINS, carbon_intensity=CI,
                          key=3, config=cfg, **kw)


JAX = type("JAX", (), dict(opt=jopt, Scenario=jsc.Scenario, w=JW, dc=JDC))
PORT = type("PORT", (), dict(opt=popt, Scenario=psc.Scenario, w=PW, dc=DC))


@pytest.mark.parametrize("n", ENTRIES)
def test_optimize_sharded_matches_unsharded(n):
    """The search on the sharded evaluator reproduces the unsharded search
    exactly: every candidate, objective and breakdown, the incumbent trace
    and the winner with its summary (the draws stay on the host)."""
    ref, sh = _search(PORT), _search(PORT, shard=True, mesh=_mesh(n))
    assert [c.scenario for c in ref.history] == [c.scenario for c in sh.history]
    assert [c.objective for c in ref.history] == [c.objective for c in sh.history]
    assert [c.breakdown for c in ref.history] == [c.breakdown for c in sh.history]
    np.testing.assert_array_equal(ref.incumbent_objective, sh.incumbent_objective)
    assert ref.best.scenario == sh.best.scenario
    _same_summaries([ref.best_summary, ref.baseline_summary],
                    [sh.best_summary, sh.baseline_summary])


def test_optimize_sharded_matches_jax(monkeypatch):
    """The sharded search against the JAX package's, the JAX draws fed to
    both: decisions exact, objectives at the twin's float bar."""
    inject_jax_draws(monkeypatch)
    assert_same_search(_search(PORT, shard=True, mesh=_mesh(3)), _search(JAX))


def test_optimize_whatif_sharded_matches_unsharded():
    """Stage 3's search from the orchestrator, sharded, proposes what the
    unsharded search proposes."""
    def run(**kw):
        orch = porch.Orchestrator(PW, DC, T_BINS, porch.OrchestratorConfig(device="cpu"),
                                  carbon_intensity=CI)
        return orch.optimize_whatif(key=1, config=popt.OptimizerConfig(
            batch_size=6, generations=1, init="random"), **kw)

    ref, sh = run(), run(shard=True, mesh=_mesh(4))
    assert [c.objective for c in ref.result.history] == \
        [c.objective for c in sh.result.history]
    assert [(p.kind, p.detail, p.impact) for p in ref.proposals] == \
        [(p.kind, p.detail, p.impact) for p in sh.proposals]


def test_mesh_requires_shard_flag():
    ss = psc.build_scenario_set(PW, DC, _grid(psc)[:2])
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        psc.run_scenarios(ss, max_hosts=ss.max_hosts, t_bins=T_BINS, mesh=mesh)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        psc.evaluate_scenarios(PW, DC, _grid(psc)[:2], t_bins=T_BINS, mesh=mesh)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        _search(PORT, mesh=mesh)
