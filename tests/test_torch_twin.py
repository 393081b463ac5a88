"""The port's closed twinning loop against the JAX package, end to end.

The ``golden_run`` configuration of ``tests/test_twin_core.py`` (48x16
hosts, 2 days, seed 9, carbon seed 4, one window without telemetry) runs
through JAX with its Pallas kernels in interpret mode and through the port
on the CPU, both starting from the same state
(``convert.twin_state_from_numpy``).  Decision streams must be identical,
float streams within rtol 5e-6, against JAX and against
``tests/golden/orchestrator_pre_core.npz``.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.orchestrator import Orchestrator as JOrchestrator  # noqa: E402
from repro.core.orchestrator import OrchestratorConfig as JOrchestratorConfig  # noqa: E402
from repro.core.state import init_twin_state as j_init_twin_state  # noqa: E402
from repro.core.twin import TraceGroundTruth as JTraceGroundTruth  # noqa: E402
from repro.traces.carbon import make_diurnal_carbon as j_make_diurnal_carbon  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro.traces.surf import SurfTraceSpec as JSurfTraceSpec  # noqa: E402
from repro.traces.surf import make_surf22_like as j_make_surf22_like  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig  # noqa: E402
from repro_torch.core.state import (  # noqa: E402
    SimSlice,
    TwinConfig,
    init_twin_state,
    make_telemetry,
    twin_step,
)
from repro_torch.core.telemetry import TelemetryStore, clip_to_window  # noqa: E402
from repro_torch.core.twin import TraceGroundTruth, run_surf_experiment  # noqa: E402
from repro_torch.traces.carbon import make_diurnal_carbon  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "orchestrator_pre_core.npz"
DECISIONS = ("p_idle", "p_max", "r", "proposals", "bias", "slo")
FLOATS = ("power_w", "mape", "gco2", "overall_mape")


def _as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _streams(orch):
    recs = orch.records
    rep = orch.monitor.report()[0]
    return {
        "mape": np.array([np.nan if r.mape is None else r.mape for r in recs]),
        "gco2": np.array([np.nan if r.gco2 is None else r.gco2 for r in recs]),
        "p_idle": np.array([float(_as_np(r.params.p_idle).mean()) for r in recs]),
        "p_max": np.array([float(_as_np(r.params.p_max).mean()) for r in recs]),
        "r": np.array([float(_as_np(r.params.r).mean()) for r in recs]),
        "power_w": np.stack([_as_np(r.prediction.power_w).astype(np.float32)
                             for r in recs]),
        "proposals": np.array([r.proposals for r in recs], np.int64),
        "overall_mape": np.float64(orch.overall_mape()),
        "bias": np.array([orch.bias.under, orch.bias.over, orch.bias.ties],
                         np.int64),
        "slo": np.array([rep.samples, rep.compliant], np.int64),
    }


@pytest.fixture(scope="module")
def golden_runs():
    """The golden configuration through JAX (pallas_interpret) and the port."""
    g = np.load(GOLDEN)
    skip = int(g["skip_window"])
    days = 2.0
    t_bins = int(days * BINS_PER_DAY)

    jdc = JDatacenterConfig(num_hosts=48, cores_per_host=16)
    jw = j_make_surf22_like(JSurfTraceSpec(days=days, seed=9), jdc)
    jorch = JOrchestrator(jw, jdc, t_bins, JOrchestratorConfig(
        bins_per_window=36, kernel_backend="pallas_interpret"),
        carbon_intensity=j_make_diurnal_carbon(t_bins, seed=4))
    leaves = [np.asarray(x) for x in
              jax.tree_util.tree_leaves(j_init_twin_state(jorch.twin_cfg))]
    jtruth = JTraceGroundTruth(jw, jdc, t_bins)

    dc = DatacenterConfig(num_hosts=48, cores_per_host=16)
    w = make_surf22_like(SurfTraceSpec(days=days, seed=9), dc, device="cpu")
    orch = Orchestrator(w, dc, t_bins, OrchestratorConfig(
        bins_per_window=36, device="cpu"),
        carbon_intensity=make_diurnal_carbon(t_bins, seed=4))
    orch.state = convert.twin_state_from_numpy(leaves, orch.twin_cfg)
    truth = TraceGroundTruth(w, dc, t_bins)
    for o, tr in ((jorch, jtruth), (orch, truth)):
        for win in range(o.num_windows):
            if win != skip:
                o.store.ingest(tr.window(win, 36))
            o.run_window(win)
    return dict(golden=g, jax=_streams(jorch), port=_streams(orch),
                workloads=(jw, w), truths=(jtruth, truth), orch=orch)


def test_trace_generators_match_jax(golden_runs):
    jw, w = golden_runs["workloads"]
    for f in ("submit_bin", "duration_bins", "cores", "util_levels", "valid"):
        np.testing.assert_array_equal(getattr(w, f).numpy(), np.asarray(getattr(jw, f)))
    jtruth, truth = golden_runs["truths"]
    np.testing.assert_allclose(truth.u_th, jtruth.u_th, rtol=1e-6)
    np.testing.assert_allclose(truth.power, jtruth.power, rtol=1e-6)
    np.testing.assert_array_equal(make_diurnal_carbon(100, seed=4),
                                  j_make_diurnal_carbon(100, seed=4))


@pytest.mark.parametrize("against", ["jax", "golden"])
def test_closed_loop_decision_streams_exact(golden_runs, against):
    want, got = golden_runs[against], golden_runs["port"]
    for k in DECISIONS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("against", ["jax", "golden"])
def test_closed_loop_float_streams_close(golden_runs, against):
    want, got = golden_runs[against], golden_runs["port"]
    for k in FLOATS:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-6, err_msg=k)


def test_no_telemetry_window_predicts_but_learns_nothing(golden_runs):
    skip = int(golden_runs["golden"]["skip_window"])
    recs = golden_runs["orch"].records
    assert recs[skip].mape is None and recs[skip].proposals == 0
    assert recs[skip].gco2 is not None
    assert float(recs[skip + 1].params.r) == float(recs[skip].params.r)


@pytest.mark.parametrize("calibrate", [False, True])
def test_run_surf_experiment_matches_jax(calibrate):
    """E2 in miniature (24x8 hosts, one day) through the user entry point."""
    from repro.core.twin import run_surf_experiment as j_run_surf_experiment

    jdc = JDatacenterConfig(num_hosts=24, cores_per_host=8)
    jw = j_make_surf22_like(JSurfTraceSpec(days=1.0, seed=3), jdc)
    want = j_run_surf_experiment(
        jw, jdc, BINS_PER_DAY, calibrate=calibrate,
        cfg=JOrchestratorConfig(kernel_backend="pallas_interpret"))
    dc = DatacenterConfig(num_hosts=24, cores_per_host=8)
    w = make_surf22_like(SurfTraceSpec(days=1.0, seed=3), dc, device="cpu")
    got = run_surf_experiment(w, dc, BINS_PER_DAY, calibrate=calibrate,
                              device="cpu")
    assert len(got.records) == BINS_PER_DAY // 36
    for f in ("p_idle", "p_max", "r"):
        np.testing.assert_array_equal(
            [float(getattr(r.params, f)) for r in got.records],
            [float(getattr(r.params, f)) for r in want.records], err_msg=f)
    np.testing.assert_allclose(got.per_window_mape, want.per_window_mape,
                               rtol=5e-6)
    assert got.overall_mape == pytest.approx(want.overall_mape, rel=5e-6)
    assert got.slo_reports[0].compliant == want.slo_reports[0].compliant
    assert got.under_estimation_fraction == want.under_estimation_fraction
    assert got.des_seconds is not None and got.des_seconds >= 0.0


def test_twin_step_is_pure_and_calibrates_toward_hidden_model():
    cfg = TwinConfig(bins_per_window=12,
                     dc=DatacenterConfig(num_hosts=8, cores_per_host=4),
                     device="cpu")
    state = init_twin_state(cfg)
    rng = np.random.default_rng(3)
    for _ in range(4):
        u = rng.uniform(0, 1, (12, 8)).astype(np.float32)
        real = (70.0 + 280.0 * (2 * u - u ** 3.5)).sum(1).astype(np.float32)
        new, out = twin_step(state, make_telemetry(u, real, device="cpu"),
                             SimSlice(u_th=torch.from_numpy(u)))
        assert int(new.window) == int(state.window) + 1
        assert torch.equal(out.params_used.r, state.params.r)
        state = new
    assert abs(float(state.params.r) - 3.5) < 0.25
    assert int(state.hist_n) == 4


def test_cuda_device_raises_without_a_card(monkeypatch):
    """``device="cuda"`` never falls back to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dc = DatacenterConfig(num_hosts=4, cores_per_host=4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_surf22_like(SurfTraceSpec(days=0.2), dc)
    with pytest.raises(RuntimeError, match="cuda"):
        init_twin_state(TwinConfig(dc=dc))
    w = make_surf22_like(SurfTraceSpec(days=0.2), dc, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        run_surf_experiment(w, dc, 48, calibrate=True)


def test_measured_extras_override_forecasts_like_jax():
    """PUE, ambient, price and carbon forecasts, with measured telemetry
    extras overriding them in windows 0 and 2 and no telemetry in window 1:
    records (float64 cost and carbon, PUE leaf, power, MAPE) match JAX."""
    from repro.core.orchestrator import Orchestrator as JOrch
    from repro.core.telemetry import clip_to_window as j_clip
    from repro.traces.schema import Workload as JWorkload
    from repro.traces.thermal import PUEParams as JPUEParams
    from repro_torch.core.telemetry import AMBIENT_KEY, CARBON_INTENSITY_KEY, PRICE_KEY
    from repro_torch.traces.thermal import PUEParams

    t_bins, j, bpw = 72, 30, 24
    rng = np.random.default_rng(4)
    arrays = (np.sort(rng.integers(0, 48, j)).astype(np.int32),
              rng.integers(1, 12, j).astype(np.int32),
              rng.integers(1, 4, j).astype(np.int32),
              rng.uniform(0.2, 0.9, (j, 2)).astype(np.float32), np.ones(j, bool))
    traces = dict(carbon_intensity=rng.uniform(100, 500, t_bins).astype(np.float32),
                  ambient_c=rng.uniform(5, 35, t_bins).astype(np.float32),
                  price=rng.uniform(0.02, 0.4, t_bins).astype(np.float32))
    pue = dict(base=1.2, amb_coeff=0.02, load_coeff=0.1)
    jorch = JOrch(JWorkload(*arrays), JDatacenterConfig(num_hosts=3, cores_per_host=4),
                  t_bins, JOrchestratorConfig(bins_per_window=bpw, pue=JPUEParams(**pue),
                                              kernel_backend="pallas_interpret"),
                  **traces)
    orch = Orchestrator(convert.workload_from_numpy(JWorkload(*arrays), device="cpu"),
                        DatacenterConfig(num_hosts=3, cores_per_host=4), t_bins,
                        OrchestratorConfig(bins_per_window=bpw, pue=PUEParams(**pue),
                                           device="cpu"), **traces)
    u = np.asarray(jorch._ensure_sim().u_th)
    np.testing.assert_allclose(orch._ensure_sim().u_th.numpy(), u, rtol=1e-6)
    p_meas = 80.0 + 150.0 * u.sum(axis=1)
    for win in (0, 2):
        sl = slice(win * bpw, (win + 1) * bpw)
        extras = {PRICE_KEY: traces["price"][sl] * 3.0,
                  AMBIENT_KEY: traces["ambient_c"][sl] + 5.0,
                  CARBON_INTENSITY_KEY: traces["carbon_intensity"][sl] * 0.5}
        jorch.store.ingest(j_clip(win, bpw, 0, u, p_meas, **extras))
        orch.store.ingest(clip_to_window(win, bpw, 0, u, p_meas, **extras))
    for win in range(3):
        want, got = jorch.run_window(win), orch.run_window(win)
        assert (got.mape is None) == (want.mape is None)
        for f in ("mape", "gco2", "energy_cost"):
            if getattr(want, f) is not None:
                assert getattr(got, f) == pytest.approx(getattr(want, f), rel=5e-6), f
        for f in ("power_w", "pue", "gco2", "energy_cost"):
            np.testing.assert_allclose(getattr(got.prediction, f).numpy(),
                                       np.asarray(getattr(want.prediction, f)),
                                       rtol=5e-6, err_msg=f)
        assert got.proposals == want.proposals
        assert float(got.params.r) == float(want.params.r)


def test_feedback_gate_and_monitors_match_jax():
    """Proposal rules, the HITL gate (auto-approve, reject, leave pending),
    the SLO monitor and the bias tracker give JAX's answers on the same
    seeded window stream."""
    from repro.core import feedback as jfb
    from repro.core import slo as jslo
    from repro_torch.core import feedback as fb
    from repro_torch.core import slo

    def policy(p):
        return {"scale_up": False, "power_cap": None}.get(p.kind.value, True)

    rng = np.random.default_rng(21)
    gates = {jfb: jfb.HITLGate(policy=policy), fb: fb.HITLGate(policy=policy)}
    drained = {jfb: [], fb: []}
    for win in range(16):
        kw = dict(mape=None if win % 5 == 3 else float(rng.uniform(0.0, 20.0)),
                  mean_util=float(rng.uniform(0.0, 1.0)),
                  queue_len=float(rng.choice([0.0, 0.5, 20.0, 80.0])),
                  power_w=float(rng.uniform(5e4, 1e5)),
                  power_cap_w=None if win % 2 else 7.5e4)
        for mod, gate in gates.items():
            for p in mod.propose_from_state(win, **kw):
                gate.submit(p)
            drained[mod] += [(p.kind.value, p.window, p.detail, p.impact)
                             for p in gate.drain()]
    assert drained[fb] == drained[jfb] and drained[fb]
    assert ([(p.kind.value, p.window) for p in gates[fb].pending()]
            == [(p.kind.value, p.window) for p in gates[jfb].pending()])
    assert gates[fb].pending()

    values = rng.uniform(0.0, 20.0, 40)
    real = rng.uniform(1e3, 2e3, 40)
    sim = np.where(rng.uniform(size=40) < 0.2, real, real + rng.normal(0, 50, 40))
    mon, jmon = slo.SLOMonitor([slo.NFR1]), jslo.SLOMonitor([jslo.NFR1])
    bias, jbias = slo.BiasTracker(), jslo.BiasTracker()
    for m, b in ((mon, bias), (jmon, jbias)):
        m.observe("mape", values)
        m.observe("latency", values)          # another metric: not scored
        b.observe(real, sim)
    (rep,), (jrep,) = mon.report(), jmon.report()
    assert (rep.samples, rep.compliant, rep.met) == (jrep.samples, jrep.compliant, jrep.met)
    assert (bias.under, bias.over, bias.ties) == (jbias.under, jbias.over, jbias.ties)
    assert bias.under_fraction == jbias.under_fraction and bias.ties > 0


def test_telemetry_store_windows_and_clipping():
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    p = rng.uniform(100, 200, 50)
    store = TelemetryStore(bins_per_window=12)
    # a producer slice that overflows window 1 and runs short of window 4
    for win in (1, 4, 2):
        store.ingest(clip_to_window(win, 12, 0, u, p, carbon_intensity=p))
    assert store.windows() == [1, 2, 4] and store.latest() == 4
    assert [tw.window for tw in store.history(4, 3)] == [2, 4]
    tw = store.get(1)
    np.testing.assert_array_equal(tw.power_w, p[12:24])
    np.testing.assert_array_equal(tw.extras["carbon_intensity"], p[12:24])
    short = store.get(4)                        # bins 48, 49 then forward fill
    np.testing.assert_array_equal(short.power_w, [p[48]] + [p[49]] * 11)
    assert store.get(3) is None
    with pytest.raises(ValueError, match="already ingested"):
        store.ingest(clip_to_window(1, 12, 0, u, p))
    with pytest.raises(ValueError, match="expected 12"):
        store.ingest(clip_to_window(0, 10, 0, u, p))


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _optional_imports(path: pathlib.Path) -> set[str]:
    """Modules imported inside a ``try`` that catches ``ImportError``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                for h in node.handlers):
            for stmt in node.body:
                if isinstance(stmt, ast.Import):
                    names.update(a.name for a in stmt.names)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    """No JAX, no JAX package, no msgpack, no hypothesis; ``zstandard``
    only as the codec's optional import (the reference's policy)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / name for name in ("chip_smoke.py", "e2_compare.py", "kernel_compare.py",
                                       "place_profile.py", "smoke_compare.py",
                                       "examples/live_twin_training_torch.py")]
    assert len(files) > 20
    assert ROOT / "src" / "repro_torch" / "core" / "optimize.py" in files
    codec = ROOT / "src" / "repro_torch" / "core" / "codec.py"
    assert _optional_imports(codec) == {"zstandard"}
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            if f == codec and top == "zstandard":
                continue
            assert top not in ("jax", "jaxlib", "repro", "msgpack",
                               "zstandard", "hypothesis"), (f, name)
