"""The port's five user-facing examples against their JAX counterparts.

Each ``examples/*_torch.py`` runs on the CPU (``--device cpu``) and is held
against the JAX example on the same inputs: decisions and counts exactly
(windows, SLO MET/MISSED, parameter streams, schedules, cache hits,
proposal kinds), the twin's float streams at rtol 5e-6 and what the
readout computes at rtol 1e-4.  The JAX examples run as they are where
they are quick on this CPU, their results read through spies on the
library calls they make; where they are slow their computation is rebuilt
from ``repro`` at a reduced size, given with the example:

* quickstart: the JAX example's ``main`` (1 day, 277 hosts), its printed
  lines equal to the port's;
* E1 (``reproduce_footprinter``): ``benchmarks/e1_footprinter.run`` at 2 of
  its 7 days;
* fleet: the JAX example's ``main``; the port is fed its sites (the port's
  own sites' power is within rtol 1e-6 of them: the hidden power is
  torch's ``pow`` against XLA's, summed over 32 hosts);
* what-if: the JAX example's sweep and search rebuilt at 0.5 of its 2
  days; the search is fed the JAX package's draws, as
  ``tests/test_torch_optimize.py`` feeds them;
* service: the JAX example's ``main``; the port is fed the JAX producers'
  events (their power is within 2 float32 ulps of the port producers').

And without a card each example raises on its default ``--device cuda``.
"""

import importlib
import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import _assert_state_matches  # noqa: E402
from test_torch_optimize import inject_jax_draws, sc_key  # noqa: E402
from test_torch_scenarios import assert_summaries  # noqa: E402
from test_torch_serve import _assert_output_close  # noqa: E402

from repro.core import scenarios as jsc  # noqa: E402
from repro.core.desim import PLACEMENT_POLICIES  # noqa: E402
from repro.traces.carbon import make_diurnal_carbon as jax_diurnal_carbon  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro.traces.surf import SurfTraceSpec as JSurfTraceSpec  # noqa: E402
from repro.traces.surf import make_surf22_like as jax_surf22_like  # noqa: E402
from repro_torch.core.state import state_with_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWIN_RTOL = 5e-6
READOUT_RTOL = 1e-4
EXAMPLES = ("quickstart", "reproduce_footprinter", "fleet_of_twins", "whatif_scaling",
            "twin_service")

jopt = importlib.import_module("repro.core.optimize")


def _load(path: pathlib.Path):
    """A script of the repo as a module (registered, as its dataclasses need)."""
    name = f"_example_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name: str, torch_side: bool = True):
    return _load(ROOT / "examples" / f"{name}{'_torch' if torch_side else ''}.py")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def spy(monkeypatch, module, name, seen: list):
    """Record every result of ``module.name`` in ``seen``."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, wrapper)


def _params(records):
    return np.array([[float(getattr(r.params, f)) for f in ("p_idle", "p_max", "r")]
                     for r in records])


def assert_same_run(got, want):
    """Two closed-loop runs (``TwinRunResult``): windows, SLO verdicts and
    the parameter stream exact, the MAPE stream at the twin's bar, each
    window's prediction at the readout's."""
    assert len(got.records) == len(want.records)
    np.testing.assert_array_equal(_params(got.records), _params(want.records))
    np.testing.assert_allclose(got.per_window_mape, want.per_window_mape, rtol=TWIN_RTOL,
                               equal_nan=True)
    assert got.overall_mape == pytest.approx(want.overall_mape, rel=TWIN_RTOL)
    assert [(r.slo.name, r.met, r.compliance) for r in got.slo_reports] == \
        [(r.slo.name, r.met, r.compliance) for r in want.slo_reports]
    assert got.under_estimation_fraction == want.under_estimation_fraction
    assert [p.kind.value for p in got.approved_proposals] == \
        [p.kind.value for p in want.approved_proposals]
    for a, b in zip(got.records, want.records):
        for f in ("power_w", "energy_kwh", "tflops", "utilization"):
            np.testing.assert_allclose(getattr(a.prediction, f).numpy(),
                                       np.asarray(getattr(b.prediction, f)),
                                       rtol=READOUT_RTOL, err_msg=f)


def test_quickstart_matches_jax(monkeypatch, capsys):
    jq, pq = example("quickstart", False), example("quickstart")
    seen = []
    spy(monkeypatch, jq, "run_surf_experiment", seen)
    jq.main()
    want_lines = capsys.readouterr().out.splitlines()
    got = pq.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want_lines
    assert len(got.result.records) == 8
    assert_same_run(got.result, seen[0])


def test_reproduce_footprinter_matches_jax(capsys):
    e1 = _load(ROOT / "benchmarks" / "e1_footprinter.py")
    want = e1.run(days=2.0)
    got = example("reproduce_footprinter").main(["--device", "cpu", "--days", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[-3].startswith("FootPrinter (hand-tuned, run once) MAPE")
    assert "(paper: 7.86%)" in out[-3] and "(paper: 5.13%)" in out[-2]
    assert got["opendt_mape"] == pytest.approx(want["opendt_mape"], rel=TWIN_RTOL)
    assert got["footprinter_mape"] == pytest.approx(want["footprinter_mape"], rel=TWIN_RTOL)
    assert got["improvement_pp"] == pytest.approx(want["improvement_pp"], rel=1e-4)
    for k in ("mean_utilization", "peak_tflops_hour", "mean_tflops",
              "best_efficiency_tflops_per_kwh", "efficiency_at_peak_perf"):
        assert got[k] == pytest.approx(want[k], rel=READOUT_RTOL), k
    assert got["underutilization_insight"] == want["underutilization_insight"]
    assert len(got["per_window_mape"]) == 2 * 288 // 36


def test_fleet_of_twins_matches_jax(monkeypatch, capsys):
    jf, pf = example("fleet_of_twins", False), example("fleet_of_twins")
    ran = []
    spy(monkeypatch, jf, "run_fleet", ran)
    jf.main()
    want_lines = capsys.readouterr().out.splitlines()
    # the port's own sites: the same utilization, power within rtol 1e-6
    for d in range(pf.NUM_DC):
        args = (11 + d, pf.HIDDEN_R[d], pf.UTIL_MEAN[d])
        (u, p), (ju, jp) = pf.synth_site(*args), jf.synth_site(*args)
        np.testing.assert_array_equal(u, ju)
        np.testing.assert_allclose(p, jp, rtol=1e-6)
    monkeypatch.setattr(pf, "synth_site", lambda seed, r, m, **kw: jf.synth_site(seed, r, m))
    got = pf.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    # the MAPE table and the calibrated exponents print alike
    assert lines[1:-3] == want_lines[1:-3]
    jfinal, jouts = ran[0]
    np.testing.assert_allclose(got.mape, np.asarray(jouts.mape), rtol=TWIN_RTOL)
    for f in ("p_idle", "p_max", "r"):
        np.testing.assert_array_equal(getattr(got.outputs.params_next, f).numpy(),
                                      np.asarray(getattr(jouts.params_next, f)))
    _assert_state_matches(got.final, jfinal, "final fleet")
    assert got.r.tolist() == [float(np.asarray(jfinal.params.r)[d]) for d in range(4)]


def _jax_whatif(days: float):
    """The JAX example's sweep and search (``examples/whatif_scaling.py``),
    at ``days``."""
    t_bins = int(days * 288)
    base = JDatacenterConfig()
    w = jax_surf22_like(JSurfTraceSpec(days=days), base)
    intensity = jax_diurnal_carbon(t_bins)
    policies = sorted(PLACEMENT_POLICIES)
    cands = [jsc.Scenario(name=f"{p}-h{h}", policy=p, num_hosts=h,
                          backfill_depth=0 if p == "worst_fit" else 8)
             for h in (64, 128, 200, 277) for p in policies]
    cands += [jsc.Scenario(name="carbon-cap", carbon_cap_base_w=48_000.0,
                           carbon_cap_slope=-60.0),
              jsc.Scenario(name="shift-3h", shift_bins=36),
              jsc.Scenario(name="shift-6h", shift_bins=72)]
    _, _, _, summaries = jsc.evaluate_scenarios(w, base, cands, t_bins=t_bins,
                                                carbon_intensity=intensity)
    space = jopt.SearchSpace(
        structures=tuple(jsc.Scenario(name=p, policy=p,
                                      backfill_depth=0 if p == "worst_fit" else 8)
                         for p in policies),
        carbon_cap_base_w=(35_000.0, 80_000.0), carbon_cap_slope=(-80.0, 0.0),
        shift_bins=(0, 72))
    res = jopt.optimize(w, base, space,
                        jopt.ObjectiveSpec(w_gco2_kg=1.0, w_wait=0.5, w_unplaced=50.0,
                                           w_throttled=0.1),
                        t_bins=t_bins, carbon_intensity=intensity, key=0,
                        config=jopt.OptimizerConfig(batch_size=16, generations=3))
    return summaries, res


def test_whatif_scaling_matches_jax(monkeypatch, capsys):
    pw = example("whatif_scaling")
    want_summaries, want = _jax_whatif(0.5)
    inject_jax_draws(monkeypatch)
    got = pw.main(["--device", "cpu", "--days", "0.5"])
    capsys.readouterr()
    assert [s.name for s in got.summaries] == [c.name for c in pw.candidates()]
    assert len(got.summaries) == 19
    assert_summaries(got.summaries, want_summaries, rtol=READOUT_RTOL)
    # the search: every candidate, its lane and feasibility exact, the
    # objective at the readout's bar
    assert (got.search.candidates, got.search.evaluations, got.search.batches) == \
        (want.candidates, want.evaluations, want.batches)
    assert len(got.search.history) == len(want.history)
    for a, b in zip(got.search.history, want.history):
        assert sc_key(a.scenario) == sc_key(b.scenario)
        assert (a.feasible, a.generation, a.lane) == (b.feasible, b.generation, b.lane)
        assert a.objective == pytest.approx(b.objective, rel=READOUT_RTOL)
    assert sc_key(got.search.best.scenario) == sc_key(want.best.scenario)
    assert sc_key(got.search.baseline.scenario) == sc_key(want.baseline.scenario)
    assert_summaries([got.search.best_summary, got.search.baseline_summary],
                     [want.best_summary, want.baseline_summary], rtol=READOUT_RTOL)
    # each topology's policy winner, as the JAX example picks it
    for h, win in got.winners.items():
        group = [s for s in want_summaries if s.num_hosts == h
                 and s.shift_bins == 0 and s.carbon_cap_base_w is None]
        fewest = min(s.unplaced_jobs for s in group)
        jwin = min((s for s in group if s.unplaced_jobs == fewest), key=lambda s: (
            s.mean_wait_bins if math.isfinite(s.mean_wait_bins) else math.inf,
            s.energy_kwh))
        assert win.name == jwin.name


def test_twin_service_matches_jax(monkeypatch, capsys):
    js, ps = example("twin_service", False), example("twin_service")
    made = []

    class Recorded(js.TwinService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.runs, self.evicted = [], None
            made.append(self)

        def run_until_idle(self, **kw):
            out = super().run_until_idle(**kw)
            self.runs.append(out)
            return out

        def evict(self, tenant):
            self.evicted = super().evict(tenant)
            return self.evicted

    monkeypatch.setattr(js, "TwinService", Recorded)
    js.main()
    want_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(ps, "producer",
                        lambda tenant, seed, **kw: js.producer(tenant, seed))
    got = ps.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    # restore, eviction and the bitwise line print alike
    assert lines[3:6] == want_lines[3:6]
    (a, b), (new,) = made[0].runs, made[1].runs
    for mine, theirs in ((got.results_a, a), (got.results_b, b)):
        assert [(r.tenant, r.window, r.cached) for r in mine] == \
            [(r.tenant, r.window, r.cached) for r in theirs]
        for r, q in zip(mine, theirs):
            _assert_output_close(r.output, q.output, TWIN_RTOL, f"{r.tenant} w{r.window}")
    assert got.windows_cached == made[0].stats.windows_cached == 16
    assert got.hit_rate == made[0].cache.hit_rate
    assert (got.new_windows, got.stale_dropped) == (len(new), made[1].stats.stale_dropped)
    assert sorted(got.restored) == sorted(f"tenant-{g}{i}" for g in "ab" for i in range(4))
    assert got.bitwise_same
    assert got.next_window == made[1].evicted.next_window
    # the evicted session is the checkpointed one, bit for bit, and JAX's
    for x, y in zip(got.evicted, got.checkpointed):
        np.testing.assert_array_equal(x, y)
    cfg = ps.TwinConfig(bins_per_window=ps.BINS, device="cpu",
                        dc=ps.DatacenterConfig(num_hosts=ps.HOSTS, cores_per_host=16))
    _assert_state_matches(state_with_leaves([torch.from_numpy(x) for x in got.evicted], cfg),
                          made[1].evicted.state, "evicted tenant-b0")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_asks_for_the_card(name, monkeypatch):
    """On a machine without a card the default ``--device cuda`` raises
    before any work (the card's absence is forced where one is present)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example(name).main([])
