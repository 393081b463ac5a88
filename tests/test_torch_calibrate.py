"""The port's Self-Calibrator and power models against the JAX package's.

Grid points are chosen by an argmin over the same host-built grid, so the
chosen parameters must be identical, degenerate histories included.
Refined rounds build their grids from tensor bounds (``jnp.linspace`` vs
the port's lerp) and are held at rtol 1e-6.  The JAX side runs its Pallas
kernel in interpret mode; the port runs its plain version on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reference import reference_calibrate_per_host  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import power as jpower  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.core.power import opendc_power as jopendc  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import power  # noqa: E402
from repro_torch.core.power import PowerParams, mape  # noqa: E402

BASE = (70.0, 350.0, 2.0)


def _window(seed, t=96, h=16, hidden_r=None, noise=0.01):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.05, 0.95, (t, h)).astype(np.float32)
    r = float(rng.uniform(1.5, 4.5)) if hidden_r is None else hidden_r
    p = np.asarray(jopendc(jnp.asarray(u), JPowerParams(75.0, 360.0, r))).sum(1)
    real = (p * (1.0 + noise * rng.standard_normal(t))).astype(np.float32)
    return u, real


def _both(u, real, spec_kw, base=BASE):
    """(port params, port mape), (jax params, jax mape) for one window."""
    jspec = jcal.CalibrationSpec(**spec_kw)
    jbase = JPowerParams(*base)
    jp, jm = jax.jit(jcal.calibrate_traced,
                     static_argnames=("spec", "backend"))(
        jnp.asarray(u), jnp.asarray(real), jcal.candidate_grid(jspec, jbase),
        jspec, jbase, backend="pallas_interpret")
    spec = cal.CalibrationSpec(**spec_kw)
    pbase = PowerParams(*base)
    pp, pm = cal.calibrate_traced(
        torch.from_numpy(u), torch.from_numpy(real),
        cal.candidate_grid(spec, pbase, device="cpu"), spec, pbase)
    as_np = lambda p: tuple(np.asarray(getattr(p, f)) for f in ("p_idle", "p_max", "r"))  # noqa: E731
    return ((tuple(x.numpy() for x in (pp.p_idle, pp.p_max, pp.r)), float(pm)),
            (as_np(jp), float(jm)))


@pytest.mark.parametrize("mode", ["r_only", "joint"])
def test_candidate_grid_is_bitwise_the_jax_grid(mode):
    spec_kw = dict(mode=mode, r_points=16, scale_points=5)
    for base in (BASE, (300.0, 350.0, 2.0)):       # narrow span clamps p_max
        want = jcal.candidate_grid(jcal.CalibrationSpec(**spec_kw), JPowerParams(*base))
        got = cal.candidate_grid(cal.CalibrationSpec(**spec_kw), PowerParams(*base),
                                 device="cpu")
        for f in ("p_idle", "p_max", "r"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("mode", ["r_only", "joint"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_choice_identical_to_jax(mode, seed):
    u, real = _window(seed)
    (pp, pm), (jp, jm) = _both(u, real, dict(mode=mode, r_points=32,
                                             scale_points=6))
    for a, b in zip(pp, jp):
        np.testing.assert_array_equal(a, b)
    assert pm == pytest.approx(jm, rel=1e-5)


@pytest.mark.parametrize("mode", ["r_only", "joint"])
def test_refined_parameters_match_jax(mode):
    u, real = _window(7)
    (pp, pm), (jp, jm) = _both(u, real, dict(mode=mode, r_points=16,
                                             scale_points=5, refine_iters=2))
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert pm == pytest.approx(jm, rel=1e-5)


@pytest.mark.parametrize("refine", [0, 2])
def test_all_zero_history_keeps_base(refine):
    u, _ = _window(3)
    zeros = np.zeros(u.shape[0], np.float32)
    (pp, pm), (jp, jm) = _both(u, zeros, dict(mode="joint", r_points=8,
                                              scale_points=3, refine_iters=refine))
    assert np.isnan(pm) and np.isnan(jm)
    for a, b, want in zip(pp, jp, BASE):
        assert float(a) == float(b) == want


def test_single_finite_bin_history_matches_jax():
    u, real = _window(4, hidden_r=2.6, noise=0.0)
    one = np.zeros_like(real)
    one[7] = real[7]
    (pp, pm), (jp, jm) = _both(u, one, dict(r_points=16))
    for a, b in zip(pp, jp):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(pm) and pm == pytest.approx(jm, rel=1e-5, abs=1e-6)


def test_per_host_rows_exact_vs_jax_and_oracle():
    """The per-host refit (one batched kernel call over hosts) picks the
    same row per host as JAX and as the float64 loop oracle."""
    rng = np.random.default_rng(11)
    r_h = np.array([1.4, 2.6, 4.2, 3.1], np.float32)
    u = rng.uniform(0.05, 0.95, (64, 4)).astype(np.float32)
    real = np.asarray(jopendc(jnp.asarray(u), JPowerParams(
        jnp.full((4,), 70.0), jnp.full((4,), 350.0), jnp.asarray(r_h)))).sum(1)
    real = real.astype(np.float32)
    spec_kw = dict(r_points=48, per_host=True)
    (pp, pm), (jp, jm) = _both(u, real, spec_kw)
    for a, b in zip(pp, jp):
        assert a.shape == (4,)
        np.testing.assert_array_equal(a, b)
    assert pm == pytest.approx(jm, rel=1e-4)
    spec = cal.CalibrationSpec(r_points=48)
    cand = cal.candidate_grid(spec, PowerParams(*BASE), device="cpu")
    fp, fm = cal.calibrate_traced(torch.from_numpy(u), torch.from_numpy(real),
                                  cand, spec, PowerParams(*BASE))
    ref_rows, ref_m = reference_calibrate_per_host(
        u.astype(np.float64).tolist(), real.astype(np.float64).tolist(),
        list(zip(cand.p_idle.tolist(), cand.p_max.tolist(), cand.r.tolist())),
        (float(fp.p_idle), float(fp.p_max), float(fp.r)), float(fm))
    for a, b in zip(pp, ref_rows):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert pm == pytest.approx(ref_m, rel=1e-3)


def test_per_host_all_zero_window_keeps_fleet_rows():
    u, _ = _window(9, t=32, h=5)
    (pp, pm), (jp, jm) = _both(u, np.zeros(32, np.float32),
                               dict(r_points=8, per_host=True))
    assert np.isnan(pm) and np.isnan(jm)
    np.testing.assert_array_equal(pp[2], np.full(5, 2.0, np.float32))
    np.testing.assert_array_equal(pp[2], jp[2])


def test_mape_semantics():
    real = torch.tensor([100.0, 0.0, 200.0])
    sim = torch.tensor([110.0, 5.0, 180.0])
    assert float(mape(real, sim)) == pytest.approx(10.0, rel=1e-6)
    assert np.isnan(float(mape(torch.zeros(3), sim)))
    with pytest.raises(ValueError, match="r must be finite"):
        PowerParams(r=0.0)
    with pytest.raises(ValueError, match="p_max must be >= p_idle"):
        PowerParams(p_idle=100.0, p_max=90.0)
    rng = np.random.default_rng(12)
    real = rng.uniform(1e3, 5e3, 50).astype(np.float32)
    real[::7] = 0.0
    sim = (real * rng.uniform(0.8, 1.2, 50) + 3.0).astype(np.float32)
    assert float(mape(torch.from_numpy(real), torch.from_numpy(sim))) == \
        pytest.approx(float(jpower.mape(jnp.asarray(real), jnp.asarray(sim))), rel=1e-6)


@pytest.mark.parametrize("model", ["opendc", "linear", "sqrt", "cubic"])
@pytest.mark.parametrize("per_host", [False, True])
def test_power_models_match_jax(model, per_host):
    """``datacenter_power`` with an online mask, then ``energy_kwh`` and
    ``carbon_gco2``, for scalar and per-host parameters."""
    rng = np.random.default_rng(len(model) + 10 * per_host)
    t, h = 30, 9
    u = rng.uniform(-0.1, 1.1, (t, h)).astype(np.float32)
    mask = (rng.uniform(size=(t, h)) < 0.8).astype(np.float32)
    ci = rng.uniform(50.0, 600.0, t).astype(np.float32)
    p = ((rng.uniform(50, 90, h).astype(np.float32),
          rng.uniform(250, 450, h).astype(np.float32),
          rng.uniform(1.2, 4.0, h).astype(np.float32)) if per_host
         else (71.5, 362.0, 2.7))
    jp = jpower.datacenter_power(jnp.asarray(u), JPowerParams(*p), model=model,
                                 online_mask=jnp.asarray(mask))
    tp = power.datacenter_power(torch.from_numpy(u), PowerParams(*p), model=model,
                                online_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    je = jpower.energy_kwh(jp, 300.0)
    te = power.energy_kwh(tp, 300.0)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5)
    np.testing.assert_allclose(power.carbon_gco2(te, ci).numpy(),
                               np.asarray(jpower.carbon_gco2(je, jnp.asarray(ci))),
                               rtol=1e-5)
