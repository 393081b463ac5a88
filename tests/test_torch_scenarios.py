"""The port's batched what-if engine against the JAX package's.

``build_scenario_set``, ``run_scenarios`` (unfused, and fused against the
JAX package's ``use_pallas=True`` in interpret mode), ``summarize_scenarios``,
``Orchestrator.evaluate_whatif`` and the validation of ``Scenario``,
``HostFailure`` and ``run_scenarios``, on the same inputs made from a seed
with numpy.  Bars: integers and decisions exact; the unfused floats at rtol
5e-6 (the twin's float bar, ROADMAP's parity contract); the fused readout at
``tests/test_torch_readout_lanes.py``'s bars (rtol 1e-5, bf16 performance
leaves within one bf16 ulp); the pre-carbon golden's integers exact and its
floats at rtol 5e-6, never bitwise.
"""

import math
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import orchestrator as jorch  # noqa: E402
from repro.core import scenarios as jsc  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.traces import schema as jschema  # noqa: E402
from repro.traces import surf as jsurf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import orchestrator as porch  # noqa: E402
from repro_torch.core import scenarios as psc  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.traces import schema, surf  # noqa: E402

#: each package's names, so one scenario list is written once
JAX = types.SimpleNamespace(Scenario=jsc.Scenario, HostFailure=jfault.HostFailure,
                            PowerParams=JPowerParams, DC=jschema.DatacenterConfig,
                            build=jsc.build_scenario_set, run=jsc.run_scenarios,
                            evaluate=jsc.evaluate_scenarios)
PORT = types.SimpleNamespace(Scenario=psc.Scenario, HostFailure=fault.HostFailure,
                             PowerParams=PowerParams, DC=schema.DatacenterConfig,
                             build=psc.build_scenario_set, run=psc.run_scenarios,
                             evaluate=psc.evaluate_scenarios)

INT_SIM = ("job_start", "job_host", "queue_len", "running")
LEAVES = ("power_w", "energy_kwh", "tflops", "utilization", "efficiency", "gco2",
          "power_demand_w", "pue", "energy_cost")
BF16_ULP = 2.0 ** -8
TWIN_RTOL = 5e-6


def random_case(seed, j=24, hosts=3, cores_per_host=8, t_bins=40):
    """``tests/test_new_axes.py``'s randomized case: a contended trace with
    deferrable jobs, and carbon, ambient and price traces."""
    rng = np.random.default_rng(seed)
    jw = jschema.Workload(
        jnp.asarray(np.sort(rng.integers(0, t_bins // 2, j)).astype(np.int32)),
        jnp.asarray(rng.integers(1, 8, j).astype(np.int32)),
        jnp.asarray(rng.integers(1, cores_per_host + 1, j).astype(np.int32)),
        jnp.asarray(rng.uniform(0.1, 1.0, (j, 3)).astype(np.float32)),
        jnp.ones((j,), bool), deferrable=jnp.asarray(rng.random(j) < 0.6))
    traces = dict(carbon_intensity=rng.uniform(80.0, 600.0, t_bins).astype(np.float32),
                  ambient_c=rng.uniform(5.0, 35.0, t_bins).astype(np.float32),
                  price=rng.uniform(0.02, 0.45, t_bins).astype(np.float32))
    return jw, hosts, cores_per_host, t_bins, traces


def axis_mix(m, hosts, t_bins):
    """``tests/test_new_axes.py:67``'s mix, widened to the four policies,
    backfill 0 and 3, static and carbon-aware caps, PUE with ambient, time
    shifts and the three workload scales."""
    hf = m.HostFailure
    watts = hosts * 120.0
    return [
        m.Scenario(name="base"),
        m.Scenario(name="outage", failures=(hf(0, t_bins // 4, t_bins // 2),)),
        m.Scenario(name="drain", failures=(
            hf(hosts - 1, 5, t_bins - 3, kind="degraded"),)),
        m.Scenario(name="multi-fail", policy="first_fit", failures=(
            hf(0, 3, 11), hf(1, 8, 20, kind="degraded"))),
        m.Scenario(name="pue", pue_base=1.15, pue_amb_coeff=0.02, pue_amb_ref=16.0,
                   pue_load_coeff=0.12),
        m.Scenario(name="pue-cap", pue_base=1.3, power_cap_w=watts * 1.8),
        m.Scenario(name="fail-pue-shift", shift_bins=5, pue_base=1.1,
                   pue_load_coeff=0.2, failures=(hf(1, t_bins // 3, t_bins // 2),)),
        m.Scenario(name="bf-fail", policy="best_fit", backfill_depth=3,
                   failures=(hf(0, 10, 25),)),
        m.Scenario(name="carbon-cap", policy="random_fit", backfill_depth=3,
                   carbon_cap_base_w=watts * 2.2, carbon_cap_slope=-0.4),
        m.Scenario(name="scaled", num_hosts=hosts - 1, util_scale=1.4,
                   arrival_scale=1.5, duration_scale=0.7, p_max=300.0),
    ]


def jax_workload_to_port(jw):
    return convert.workload_from_numpy(jw, device="cpu")


def assert_sim(got, want):
    for k in INT_SIM:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.u_th.numpy(), np.asarray(want.u_th), rtol=TWIN_RTOL,
                               atol=0.0)


def assert_pred(got, want, rtol, precision="f32"):
    for k in LEAVES:
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is None:
            continue
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        if precision == "bf16" and k in ("tflops", "efficiency"):
            assert np.all(np.abs(g - w) <= BF16_ULP * np.abs(w)), k
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)


def assert_summaries(got, want, rtol=TWIN_RTOL):
    """Integer and string fields equal, floats at ``rtol``, NaN where JAX
    has NaN, None where JAX has None."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f, va in a.__dict__.items():
            vb = b.__dict__[f]
            if isinstance(vb, float):
                assert isinstance(va, float), (a.name, f)
                assert math.isnan(va) == math.isnan(vb), (a.name, f, va, vb)
                if not math.isnan(vb):
                    assert va == pytest.approx(vb, rel=rtol, abs=1e-12), (a.name, f)
            else:
                assert va == vb, (a.name, f, va, vb)


def ss_leaves(ss):
    """A ScenarioSet's array leaves as numpy, by name (either package)."""
    out = {}
    for k in ("host_mask_s", "num_hosts", "cores_per_host", "policy_id",
              "backfill_depth", "power_cap_w", "carbon_cap_base_w", "carbon_cap_slope",
              "shift_bins", "peak_tflops", "fail_start", "fail_end", "fail_kill",
              "pue_base", "pue_amb_coeff", "pue_amb_ref", "pue_load_coeff"):
        out[k] = getattr(ss, k)
    for k in ("p_idle", "p_max", "r"):
        out[f"params.{k}"] = getattr(ss.params, k)
    for k in ("submit_bin", "duration_bins", "cores", "util_levels", "valid", "deferrable"):
        out[f"workload.{k}"] = getattr(ss.workload, k)
    return {k: None if v is None else np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                                                  else v) for k, v in out.items()}


def golden_mix(m):
    """``tests/test_scenarios.py:208``'s five lanes (the pre-carbon golden)."""
    return [m.Scenario(name="base"), m.Scenario(name="h16", num_hosts=16),
            m.Scenario(name="bf", policy="best_fit", backfill_depth=2),
            m.Scenario(name="hot", util_scale=1.5),
            m.Scenario(name="cap", power_cap_w=5000.0)]


@pytest.mark.parametrize("mix", ["new_axes", "golden"])
def test_build_scenario_set_matches_jax(mix):
    if mix == "new_axes":
        jw, hosts, cph, t_bins, _ = random_case(2)
        scs = lambda m: axis_mix(m, hosts, t_bins)  # noqa: E731
        base = dict(p_idle=63.0, p_max=341.0, r=2.3)
    else:
        hosts, cph = 32, 16
        jw = jsurf.make_surf22_like(jsurf.SurfTraceSpec(days=0.25, seed=5),
                                    jschema.DatacenterConfig(num_hosts=32, cores_per_host=16))
        scs, base = golden_mix, {}
    want = JAX.build(jw, JAX.DC(num_hosts=hosts, cores_per_host=cph), scs(JAX),
                     JAX.PowerParams(**base))
    got = PORT.build(jax_workload_to_port(jw), PORT.DC(num_hosts=hosts, cores_per_host=cph),
                     scs(PORT), PORT.PowerParams(**base))
    g, w = ss_leaves(got), ss_leaves(want)
    for k in w:
        assert (g[k] is None) == (w[k] is None), k
        if w[k] is not None:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (got.names, got.max_backfill, got.has_failures, got.pue_on) == \
        (want.names, want.max_backfill, want.has_failures, want.pue_on)


@pytest.mark.parametrize("seed", [2, 13, 31])
def test_run_scenarios_unfused_matches_jax(seed):
    jw, hosts, cph, t_bins, traces = random_case(seed)
    params = dict(p_idle=63.0, p_max=341.0, r=2.3)
    _, jsim, jpred, jsum = JAX.evaluate(
        jw, JAX.DC(num_hosts=hosts, cores_per_host=cph), axis_mix(JAX, hosts, t_bins),
        t_bins=t_bins, base_params=JAX.PowerParams(**params), **traces)
    _, sim, pred, summ = PORT.evaluate(
        jax_workload_to_port(jw), PORT.DC(num_hosts=hosts, cores_per_host=cph),
        axis_mix(PORT, hosts, t_bins), t_bins=t_bins,
        base_params=PORT.PowerParams(**params), **traces)
    assert_sim(sim, jsim)
    assert_pred(pred, jpred, TWIN_RTOL)
    assert_summaries(summ, jsum)


@pytest.mark.parametrize("precision,seed", [("f32", 2), ("bf16", 13)])
def test_run_scenarios_fused_matches_jax_pallas(precision, seed):
    """``fused_readout=True`` against ``use_pallas=True`` (the Pallas readout
    in interpret mode, vmapped over the lanes)."""
    jw, hosts, cph, t_bins, traces = random_case(seed)
    params = dict(p_idle=63.0, p_max=341.0, r=2.3)
    jss = JAX.build(jw, JAX.DC(num_hosts=hosts, cores_per_host=cph),
                    axis_mix(JAX, hosts, t_bins), JAX.PowerParams(**params))
    jsim, jpred = JAX.run(jss, max_hosts=jss.max_hosts, t_bins=t_bins, use_pallas=True,
                          readout_precision=precision, **traces)
    ss = PORT.build(jax_workload_to_port(jw), PORT.DC(num_hosts=hosts, cores_per_host=cph),
                    axis_mix(PORT, hosts, t_bins), PORT.PowerParams(**params))
    sim, pred = PORT.run(ss, max_hosts=ss.max_hosts, t_bins=t_bins, fused_readout=True,
                         readout_precision=precision, **traces)
    assert_sim(sim, jsim)
    assert_pred(pred, jpred, 1e-5, precision)


def test_pre_carbon_golden():
    """``tests/golden/scenarios_pre_carbon.npz``: integers exact, floats at
    rtol 5e-6; the capped lane's demand is the golden's uncapped power and
    its delivered power that demand clipped to the cap."""
    g = np.load(pathlib.Path(__file__).parent / "golden" / "scenarios_pre_carbon.npz")
    dc = schema.DatacenterConfig(num_hosts=32, cores_per_host=16)
    w = surf.make_surf22_like(surf.SurfTraceSpec(days=0.25, seed=5), dc, device="cpu")
    cap = 5000.0
    _, sim, pred, summaries = psc.evaluate_scenarios(w, dc, golden_mix(PORT), t_bins=72)
    for k in INT_SIM:
        np.testing.assert_array_equal(getattr(sim, k).numpy(), g[k], err_msg=k)
    np.testing.assert_allclose(sim.u_th.numpy(), g["u_th"], rtol=TWIN_RTOL, atol=0.0)
    for k in ("power_w", "energy_kwh", "tflops", "utilization", "efficiency"):
        np.testing.assert_allclose(getattr(pred, k).numpy()[:4], g[k][:4], rtol=TWIN_RTOL,
                                   err_msg=k)
    demand = pred.power_demand_w[4].numpy()
    np.testing.assert_allclose(demand, g["power_w"][4], rtol=TWIN_RTOL)
    exceeded = g["power_w"][4] > cap
    delivered = pred.power_w[4].numpy()
    np.testing.assert_allclose(delivered[~exceeded], g["power_w"][4][~exceeded],
                               rtol=TWIN_RTOL)
    assert (delivered[exceeded] == np.float32(cap)).all()
    assert [s.cap_exceeded_bins for s in summaries] == g["cap_exceeded"].tolist()
    np.testing.assert_allclose([s.energy_kwh for s in summaries[:4]],
                               g["energy_total"][:4], rtol=TWIN_RTOL)


def test_summaries_nan_and_none_match_jax():
    """Without carbon or price traces: gCO2 and intensity NaN, cost and PUE
    None; a topology where nothing fits leaves the waits NaN."""
    jw, hosts, cph, t_bins, _ = random_case(5)
    mix = lambda m: [m.Scenario(name="base"), m.Scenario(name="tiny", cores_per_host=1),  # noqa: E731
                     m.Scenario(name="cap", power_cap_w=200.0)]
    *_, want = JAX.evaluate(jw, JAX.DC(num_hosts=hosts, cores_per_host=cph), mix(JAX),
                            t_bins=t_bins)
    *_, got = PORT.evaluate(jax_workload_to_port(jw), PORT.DC(num_hosts=hosts,
                                                              cores_per_host=cph),
                            mix(PORT), t_bins=t_bins)
    assert math.isnan(want[1].mean_wait_bins) and math.isnan(want[0].gco2)
    assert want[0].energy_cost is None and want[0].mean_pue is None
    assert_summaries(got, want)


#: the orchestrator what-if cases of tests/test_scenarios.py:249-306:
#: (scenarios, include_baseline, max_hosts)
WHATIF_CASES = {
    "routes gate": (lambda m: [m.Scenario(name="h32", num_hosts=32),
                               m.Scenario(name="cap", power_cap_w=100.0)], True, None),
    "without baseline": (lambda m: [m.Scenario(name="cap", power_cap_w=100.0),
                                    m.Scenario(name="h32", num_hosts=32)], False, None),
    "small max_hosts": (lambda m: [m.Scenario(name="h16", num_hosts=16),
                                   m.Scenario(name="h24", num_hosts=24)], False, 24),
    "schedulers": (lambda m: [m.Scenario(name="bf", policy="best_fit", backfill_depth=4),
                              m.Scenario(name="ff", policy="first_fit", backfill_depth=4)],
                   True, None),
}


@pytest.fixture(scope="module")
def whatif_workload():
    dc = jschema.DatacenterConfig(num_hosts=64, cores_per_host=16)
    return jsurf.make_surf22_like(jsurf.SurfTraceSpec(days=0.5, seed=11), dc)


@pytest.mark.parametrize("case", list(WHATIF_CASES))
def test_evaluate_whatif_matches_jax(case, whatif_workload):
    """The same proposal kinds and counts through the gate, the same
    summaries, with and without the baseline and with a small max_hosts."""
    scs, include, mh = WHATIF_CASES[case]
    t_bins = 144
    jo = jorch.Orchestrator(whatif_workload, jschema.DatacenterConfig(num_hosts=64,
                                                                      cores_per_host=16),
                            t_bins, jorch.OrchestratorConfig(bins_per_window=36,
                                                             calibrate=False))
    po = porch.Orchestrator(jax_workload_to_port(whatif_workload),
                            schema.DatacenterConfig(num_hosts=64, cores_per_host=16),
                            t_bins, porch.OrchestratorConfig(bins_per_window=36,
                                                             calibrate=False, device="cpu"))
    want = jo.evaluate_whatif(scs(JAX), include_baseline=include, max_hosts=mh)
    got = po.evaluate_whatif(scs(PORT), include_baseline=include, max_hosts=mh)
    assert [(p.kind.value, p.window) for p in got.proposals] == \
        [(p.kind.value, p.window) for p in want.proposals]
    assert len(po.gate.pending()) == len(jo.gate.pending())
    assert_summaries(got.summaries, want.summaries)
    assert_sim(got.sim, want.sim)
    assert_pred(got.prediction, want.prediction, TWIN_RTOL)


def test_per_host_params_survive_the_whatif_path(whatif_workload):
    """``tests/test_scenarios.py:308-354, 399``: per-host base rows reach
    the lanes, a scalar override replaces a row, added hosts take the fleet
    mean; the rows equal JAX's and the prediction matches it."""
    rng = np.random.default_rng(7)
    p_idle = rng.uniform(55.0, 95.0, 64).astype(np.float32)
    p_max = rng.uniform(300.0, 420.0, 64).astype(np.float32)
    mix = lambda m: [m.Scenario(name="keep"), m.Scenario(name="flat", p_idle=50.0,  # noqa: E731
                                                         p_max=400.0),
                     m.Scenario(name="grow", num_hosts=96)]
    dc = dict(num_hosts=64, cores_per_host=16)
    jbase = JPowerParams(p_idle=jnp.asarray(p_idle), p_max=jnp.asarray(p_max), r=2.3)
    pbase = PowerParams(p_idle=torch.from_numpy(p_idle), p_max=torch.from_numpy(p_max), r=2.3)
    jss, jsim, jpred, _ = JAX.evaluate(whatif_workload, JAX.DC(**dc), mix(JAX), t_bins=144,
                                       base_params=jbase, max_hosts=96)
    ss, sim, pred, _ = PORT.evaluate(jax_workload_to_port(whatif_workload), PORT.DC(**dc),
                                     mix(PORT), t_bins=144, base_params=pbase, max_hosts=96)
    for k in ("p_idle", "p_max", "r"):
        np.testing.assert_array_equal(getattr(ss.params, k).numpy(),
                                      np.asarray(getattr(jss.params, k)), err_msg=k)
    np.testing.assert_array_equal(ss.params.p_idle[0, :64].numpy(), p_idle)
    assert (ss.params.p_idle[1] == 50.0).all()
    np.testing.assert_allclose(ss.params.p_idle[2, 64:].numpy(), p_idle.mean(), rtol=1e-6)
    assert_sim(sim, jsim)
    assert_pred(pred, jpred, TWIN_RTOL)


#: Scenario keyword sets that both packages must reject (every check of
#: Scenario.__post_init__), then ones both must accept
BAD_SCENARIOS = [
    dict(r=0.0), dict(r=-1.0), dict(r=float("nan")), dict(p_idle=-1.0),
    dict(p_idle=float("inf")), dict(p_max=float("nan")), dict(p_idle=100.0, p_max=90.0),
    dict(power_cap_w=0.0), dict(power_cap_w=-5.0), dict(carbon_cap_base_w=0.0),
    dict(carbon_cap_base_w=1000.0, carbon_cap_slope=float("nan")),
    dict(carbon_cap_base_w=1000.0, carbon_cap_slope=float("inf")),
    dict(carbon_cap_base_w=1000.0, carbon_cap_slope=float("-inf")),
    dict(backfill_depth=32), dict(backfill_depth=-1), dict(arrival_scale=0.0),
    dict(duration_scale=-1.0), dict(util_scale=-0.1), dict(failures=("not a window",)),
    dict(pue_base=0.9), dict(pue_base=float("inf")), dict(pue_amb_coeff=-0.1, pue_base=1.2),
    dict(pue_load_coeff=float("nan"), pue_base=1.2), dict(pue_amb_ref=float("nan")),
    dict(pue_load_coeff=0.1), dict(pue_amb_coeff=0.05),
]
GOOD_SCENARIOS = [
    dict(), dict(backfill_depth=31), dict(carbon_cap_base_w=1000.0, carbon_cap_slope=-60.0),
    dict(p_idle=0.0, p_max=0.0), dict(pue_base=1.0, pue_amb_coeff=0.0),
    dict(util_scale=0.0), dict(failures=[]), dict(policy="random_fit", shift_bins=-4),
]


@pytest.mark.parametrize("kw", BAD_SCENARIOS + GOOD_SCENARIOS,
                         ids=[str(k) for k in BAD_SCENARIOS + GOOD_SCENARIOS])
def test_scenario_validation_matches_jax(kw):
    """The accept/reject rule of ``Scenario``, with the same message."""
    outcome = []
    for m in (JAX, PORT):
        try:
            m.Scenario(name="x", **kw)
            outcome.append(None)
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert (outcome[0] is None) == (kw in GOOD_SCENARIOS)


def test_scenario_validation_fuzz_matches_jax():
    """Random knob values (finite, edge and non-finite) from a fixed seed:
    both packages accept the same scenarios and reject the rest with the
    same message, the rule the JAX package's hypothesis fuzz states."""
    rng = np.random.default_rng(0)
    pool = [0.0, -1.0, 0.5, 1.0, 2.0, 50.0, 400.0, float("nan"), float("inf"),
            float("-inf"), None]
    knobs = ("p_idle", "p_max", "r", "power_cap_w", "carbon_cap_base_w", "pue_base",
             "carbon_cap_slope", "arrival_scale", "duration_scale", "util_scale",
             "pue_amb_coeff", "pue_load_coeff", "pue_amb_ref")
    optional = {"p_idle", "p_max", "r", "power_cap_w", "carbon_cap_base_w", "pue_base"}
    accepted = 0
    for _ in range(400):
        kw = {}
        for k in rng.choice(knobs, size=rng.integers(1, 4), replace=False):
            v = pool[rng.integers(len(pool))]
            if v is not None or k in optional:
                kw[str(k)] = v
        if rng.uniform() < 0.2:
            kw["backfill_depth"] = int(rng.integers(-2, 34))
        outcome = []
        for m in (JAX, PORT):
            try:
                m.Scenario(**kw)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], kw
        accepted += outcome[0] is None
    assert 20 < accepted < 380


def _tiny(m):
    jw = jschema.Workload(jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
                          jnp.asarray([1], jnp.int32), jnp.ones((1, 1), jnp.float32),
                          jnp.ones((1,), bool))
    return jw if m is JAX else jax_workload_to_port(jw)


#: (label, call): build and run rejections of tests/test_new_axes.py and
#: tests/test_scenarios.py, each taking a package namespace
BAD_CALLS = {
    "failure host out of range": lambda m: m.build(
        _tiny(m), m.DC(num_hosts=2, cores_per_host=4),
        [m.Scenario(name="s", failures=(m.HostFailure(5, 0, 3),))]),
    "two windows on one host": lambda m: m.build(
        _tiny(m), m.DC(num_hosts=2, cores_per_host=4),
        [m.Scenario(name="s", failures=(m.HostFailure(0, 0, 3), m.HostFailure(0, 4, 6)))]),
    "no scenarios": lambda m: m.build(_tiny(m), m.DC(num_hosts=2), []),
    "more hosts than max_hosts": lambda m: m.build(
        _tiny(m), m.DC(num_hosts=2), [m.Scenario(num_hosts=8)], max_hosts=4),
    "depth beyond max_backfill": lambda m: m.build(
        _tiny(m), m.DC(num_hosts=2), [m.Scenario(backfill_depth=2)], max_backfill=1),
    "max_backfill 40": lambda m: m.build(_tiny(m), m.DC(num_hosts=2), [m.Scenario()],
                                         max_backfill=40),
    "failures forced off": lambda m: m.build(
        _tiny(m), m.DC(num_hosts=2), [m.Scenario(failures=(m.HostFailure(0, 0, 3),))],
        has_failures=False),
    "pue forced off": lambda m: m.build(_tiny(m), m.DC(num_hosts=2),
                                        [m.Scenario(pue_base=1.2)], pue_on=False),
    "window past the horizon": lambda m: m.run(
        m.build(_tiny(m), m.DC(num_hosts=2, cores_per_host=4),
                [m.Scenario(name="s", failures=(m.HostFailure(0, 50, 60),))]),
        max_hosts=2, t_bins=10),
    "no ambient trace": lambda m: m.run(
        m.build(_tiny(m), m.DC(num_hosts=2, cores_per_host=4),
                [m.Scenario(name="s", pue_base=1.2, pue_amb_coeff=0.05)]),
        max_hosts=2, t_bins=10),
    "non-finite price": lambda m: m.run(
        m.build(_tiny(m), m.DC(num_hosts=2, cores_per_host=4),
                [m.Scenario(name="s", pue_base=1.2, pue_amb_coeff=0.05)]),
        max_hosts=2, t_bins=10, ambient_c=np.full(10, 20.0, np.float32),
        price=np.array([np.nan] * 10, np.float32)),
    "carbon cap without a trace": lambda m: m.run(
        m.build(_tiny(m), m.DC(num_hosts=2), [m.Scenario(carbon_cap_base_w=900.0)]),
        max_hosts=2, t_bins=10),
    "short carbon trace": lambda m: m.run(
        m.build(_tiny(m), m.DC(num_hosts=2), [m.Scenario()]), max_hosts=2, t_bins=10,
        carbon_intensity=np.full(9, 300.0, np.float32)),
}


@pytest.mark.parametrize("label", list(BAD_CALLS))
def test_build_and_run_reject_as_jax(label):
    """Each of the JAX package's build and run-time rejections raises in
    both packages with the same message."""
    msgs = []
    for m in (JAX, PORT):
        with pytest.raises(ValueError) as e:
            BAD_CALLS[label](m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
