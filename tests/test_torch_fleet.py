"""The port's fleet of twins against the JAX package's ``vmap(twin_step)``.

``calib_mape_grid`` takes per-lane candidate rows (the JAX kernel under
the fleet's ``jax.vmap``) in one call, and its shared-candidate form is
unchanged; ``fleet_step_masked``/``run_fleet`` match the JAX package's on
the same inputs (decisions exact, floats within the twin's float-stream
bar, rtol 5e-6), every lane matches the port's own solo ``twin_step``,
inactive lanes keep their state bit for bit, and one step calls the
readout once and the calibration kernel ``1 + refine_iters`` times (once
more per host), whatever the lanes hold.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import state as jstate  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.core.calibrate import CalibrationSpec as JCalibrationSpec  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.kernels.calib_mape import calib_mape_grid_pallas  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import state as pstate  # noqa: E402
from repro_torch.core import twin as ptwin  # noqa: E402
from repro_torch.core.calibrate import CalibrationSpec  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402

D, TW, H = 4, 12, 8
DC = DatacenterConfig(num_hosts=H, cores_per_host=4)
JDC = JDatacenterConfig(num_hosts=H, cores_per_host=4)
SPECS = {
    "r_only": (CalibrationSpec(), JCalibrationSpec()),
    "joint_refine": (CalibrationSpec(mode="joint", r_points=16, scale_points=5, refine_iters=1),
                     JCalibrationSpec(mode="joint", r_points=16, scale_points=5, refine_iters=1)),
    "per_host": (CalibrationSpec(per_host=True), JCalibrationSpec(per_host=True)),
}
#: each lane's base parameters differ, so do its candidate grids
BASES = [(72.0, 365.0, 2.4), (60.0, 300.0, 2.0), (80.0, 410.0, 3.1), (66.0, 280.0, 1.5)]
FLOAT_RTOL = 5e-6


def _calib_rows(seed, b, t, h, c, lanes):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (b, t, h)).astype(np.float32)
    real = rng.uniform(1e3, 5e3, (b, t)).astype(np.float32) * max(h / 4.0, 1.0)
    pi = rng.uniform(50, 90, (lanes, c)).astype(np.float32)
    pm = rng.uniform(250, 450, (lanes, c)).astype(np.float32)
    r = rng.uniform(1, 6, (lanes, c)).astype(np.float32)
    return u, real, pi, pm, r


def _old_calib_ref(u_th, real_power, p_idle, p_max, r):
    """The plain version's shared-candidate form as it was before candidate
    rows: the [C] form must keep these bits."""
    u = u_th.float().clamp(0.0, 1.0)
    real = real_power.float()
    b, t, h = u.shape
    s2 = (2.0 * u).sum(dim=2)
    log_u = torch.log(u.clamp(min=1e-30))
    rr = r.float()
    step = max(1, (1 << 24) // max(b * t * h, 1))
    sr = torch.cat([torch.exp(rr[c0:c0 + step, None, None, None] * log_u[None]).sum(dim=3)
                    for c0 in range(0, rr.shape[0], step)], dim=0)
    pi, pm = p_idle.float(), p_max.float()
    sim = h * pi[:, None, None] + (pm - pi)[:, None, None] * (s2[None] - sr)
    nonzero = real.abs() > 1e-9
    n_nz = nonzero.sum(dim=1)
    ape = ((real[None] - sim) / (real[None].abs() + 1e-9)).abs() * nonzero[None]
    out = ape.sum(dim=2).T * (100.0 / n_nz.clamp(min=1).float())[:, None]
    return torch.where(n_nz[:, None] > 0, out, torch.full_like(out, float("nan")))


@pytest.mark.parametrize("b,t,h,c", [(3, 40, 7, 9), (5, 64, 1, 16), (2, 24, 33, 130)])
def test_calib_rows_match_vmapped_pallas(b, t, h, c):
    """Candidate rows ``[B, C]``, one per batch row: the JAX kernel under
    ``jax.vmap`` (interpret mode), at the Pallas sweep's bar."""
    u, real, pi, pm, r = _calib_rows(b * t + c, b, t, h, c, b)
    real[1, ::4] = 0.0
    got = ops.calib_mape_grid(*(torch.from_numpy(a) for a in (u, real, pi, pm, r))).numpy()
    want = jax.vmap(lambda *a: calib_mape_grid_pallas(*a, interpret=True))(
        *(jnp.asarray(a) for a in (u, real, pi, pm, r)))
    assert got.shape == (b, c)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-3)


def test_calib_shared_candidates_keep_their_bits():
    """The ``[C]`` form gives exactly what it gave before candidate rows,
    batched and not."""
    u, real, pi, pm, r = _calib_rows(3, 4, 48, 9, 20, 1)
    args = [torch.from_numpy(a) for a in (u, real, pi[0], pm[0], r[0])]
    assert torch.equal(ops.calib_mape_grid(*args), _old_calib_ref(*args))
    assert torch.equal(ops.calib_mape_grid(args[0][2], args[1][2], *args[2:]),
                       _old_calib_ref(args[0][2:3], args[1][2:3], *args[2:])[0])


def test_calib_row_groups_equal_their_separate_calls():
    """``[L, C]`` rows each serving ``B / L`` batch rows (a fleet's per-host
    refit) give each group what a call of that group alone gives, bit for
    bit; a group's rows and a lane's row are the same arithmetic."""
    lanes, group = 3, 4
    u, real, pi, pm, r = _calib_rows(5, lanes * group, 30, 1, 11, lanes)
    t = [torch.from_numpy(a) for a in (u, real, pi, pm, r)]
    got = ops.calib_mape_grid(*t)
    for lane in range(lanes):
        sl = slice(lane * group, (lane + 1) * group)
        alone = ops.calib_mape_grid(t[0][sl], t[1][sl], t[2][lane], t[3][lane], t[4][lane])
        assert torch.equal(got[sl], alone)
    with pytest.raises(ValueError, match="dividing"):
        ops.calib_mape_grid(t[0][:5], t[1][:5], *t[2:])
    with pytest.raises(ValueError, match="batched"):
        ops.calib_mape_grid(t[0][0], t[1][0], *t[2:])
    with pytest.raises(ValueError, match="share one shape"):
        ops.calib_mape_grid(t[0], t[1], t[2][:, :5], t[3], t[4])
    assert torch.equal(ref.calib_mape_grid_ref(*t), got)


# -- fleets: the JAX package's vmap(twin_step) and the port's lanes -----------

def _cfgs(name, **kw):
    spec, jspec = SPECS[name]
    return (pstate.TwinConfig(bins_per_window=TW, dc=DC, calibration=spec, device="cpu", **kw),
            jstate.TwinConfig(bins_per_window=TW, dc=JDC, calibration=jspec, **kw))


def _fleets(name, **kw):
    """The same starting fleet in both packages: D lanes with differing base
    parameters (JAX's stacked leaves carried into the port)."""
    cfg, jcfg = _cfgs(name, **kw)
    jfleet = jtwin.stack_twin_states([
        jstate.init_twin_state(jcfg, JPowerParams(p_idle=a, p_max=b, r=c))
        for a, b, c in BASES])
    return convert.twin_state_from_numpy(jax.tree_util.tree_leaves(jfleet), cfg), jfleet, cfg


def _windows(seed, n):
    """``n`` windows of fleet inputs: telemetry, validity, activity."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        u = rng.uniform(0, 1, (D, TW, H)).astype(np.float32)
        p = (rng.uniform(0.5, 1.5, (D, TW)) * 1500.0).astype(np.float32)
        p[0, :3] = 0.0                                   # zero-power bins
        valid = rng.uniform(size=D) < 0.75
        valid[0] = True
        active = rng.uniform(size=D) < 0.8
        active[w % D] = True
        out.append((u, p, valid, active))
    return out


def _p_inputs(u, p, valid):
    return (pstate.TelemetrySlice(u_th=torch.from_numpy(u), power_w=torch.from_numpy(p),
                                  valid=torch.from_numpy(valid)),
            pstate.SimSlice(u_th=torch.from_numpy(u)))


def _j_inputs(u, p, valid):
    return (jstate.TelemetrySlice(u_th=jnp.asarray(u), power_w=jnp.asarray(p),
                                  valid=jnp.asarray(valid)),
            jstate.SimSlice(u_th=jnp.asarray(u)))


def _out_leaves(out):
    """A port WindowOutput's leaves in the JAX flatten order (Nones dropped)."""
    pred = [getattr(out.prediction, f.name) for f in dataclasses.fields(out.prediction)]
    rest = [out.mape, out.calib_mape, out.params_used.p_idle, out.params_used.p_max,
            out.params_used.r, out.params_next.p_idle, out.params_next.p_max,
            out.params_next.r, out.window]
    return [x for x in pred + rest if x is not None]


#: refined parameters: a refine round's grid (``calibrate._linspace``) may
#: differ from ``jnp.linspace`` in the last ulp, the bar of
#: tests/test_torch_calibrate.py's refined parameters
REFINED_RTOL = 1e-6


def _assert_params(a, b, refined, msg):
    if refined:
        np.testing.assert_allclose(a, b, rtol=REFINED_RTOL, atol=0, err_msg=msg)
    else:
        np.testing.assert_array_equal(a, b, err_msg=msg)


def _assert_out_matches(out, jout, lanes, ctx, refined=False):
    """Decisions (parameters, window) exact (refined parameters within
    REFINED_RTOL); floats within FLOAT_RTOL."""
    got, want = _out_leaves(out), [np.asarray(x) for x in jax.tree_util.tree_leaves(jout)]
    assert len(got) == len(want), ctx
    n = len(got)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy()[lanes], b[lanes]
        if i == n - 1:                      # window
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} window")
        elif i >= n - 7:                    # params_used, params_next
            _assert_params(a, b, refined, f"{ctx} leaf {i}")
        else:
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=0,
                                       equal_nan=True, err_msg=f"{ctx} leaf {i}")


def _assert_state_matches(st, jst, ctx, refined=False):
    for name, a, b in zip(pstate.state_leaf_names(st), pstate.state_leaves(st),
                          jax.tree_util.tree_leaves(jst)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        if name.startswith("params"):
            _assert_params(a, b, refined, f"{ctx} {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("name", list(SPECS))
def test_fleet_step_masked_matches_jax(name):
    """Mixed validity, mixed fill, differing bases: the port's masked fleet
    step against the JAX package's over five windows."""
    fleet, jfleet, cfg = _fleets(name)
    refined = cfg.calibration.refine_iters > 0
    jstep = jax.jit(jtwin._fleet_step_masked)
    for w, (u, p, valid, active) in enumerate(_windows(11, 5)):
        fleet, out = ptwin.fleet_step_masked(fleet, *_p_inputs(u, p, valid),
                                             torch.from_numpy(active))
        jfleet, jout = jstep(jfleet, *_j_inputs(u, p, valid), jnp.asarray(active))
        _assert_out_matches(out, jout, active, f"{name} window {w}", refined)
        _assert_state_matches(fleet, jfleet, f"{name} window {w}", refined)


@pytest.mark.parametrize("name", list(SPECS))
def test_fleet_lanes_equal_solo_twin_steps(name):
    """Each active lane against the port's own solo ``twin_step`` of that
    lane's stream: parameters and counts exact, floats within rtol 1e-6;
    an inactive lane's state is unchanged bit for bit."""
    fleet, _, cfg = _fleets(name)
    solo = [ptwin.index_twin_state(fleet, d) for d in range(D)]
    for w, (u, p, valid, active) in enumerate(_windows(12, 5)):
        before = ptwin.index_twin_state(fleet, int(np.argmin(active)))
        fleet, out = ptwin.fleet_step_masked(fleet, *_p_inputs(u, p, valid),
                                             torch.from_numpy(active))
        for d in range(D):
            lane = ptwin.index_twin_state(fleet, d)
            if not active[d]:
                for a, b in zip(pstate.state_leaves(solo[d]), pstate.state_leaves(lane)):
                    assert torch.equal(a, b), (name, w, d)
                continue
            solo[d], o = pstate.twin_step(
                solo[d], pstate.make_telemetry(u[d], p[d], bool(valid[d]), device="cpu"),
                pstate.SimSlice(u_th=torch.from_numpy(u[d])))
            for a, b in zip(_out_leaves(o), _out_leaves(out)):
                b = b[d]
                if a.dtype.is_floating_point:
                    torch.testing.assert_close(b, a, rtol=1e-6, atol=0, equal_nan=True)
            for x, y in ((o.params_next, out.params_next), (o.params_used, out.params_used)):
                for f in ("p_idle", "p_max", "r"):
                    assert torch.equal(getattr(x, f), getattr(y, f)[d]), (name, w, d, f)
            for n, a, b in zip(pstate.state_leaf_names(lane), pstate.state_leaves(solo[d]),
                               pstate.state_leaves(lane)):
                if a.dtype == torch.int32 or n.startswith(("params", "hist")):
                    assert torch.equal(a, b), (name, w, d, n)
        if not active.all():
            d = int(np.argmin(active))
            for a, b in zip(pstate.state_leaves(before),
                            pstate.state_leaves(ptwin.index_twin_state(fleet, d))):
                assert torch.equal(a, b)


def test_fleet_with_resident_sim_and_forecast_columns_matches_jax():
    """``sim_bins > 0`` (each lane slices its own window of ``sim_u``) with
    carbon and price columns per lane."""
    cfg, jcfg = _cfgs("r_only", sim_bins=3 * TW)
    rng = np.random.default_rng(4)
    sims = rng.uniform(0, 1, (D, 3 * TW, H)).astype(np.float32)
    jfleet = jtwin.stack_twin_states([jstate.init_twin_state(jcfg, sim_u=s) for s in sims])
    fleet = convert.twin_state_from_numpy(jax.tree_util.tree_leaves(jfleet), cfg)
    jstep = jax.jit(jtwin._fleet_step_masked)
    for w, (u, p, valid, active) in enumerate(_windows(13, 4)):
        ci = rng.uniform(100, 500, (D, TW)).astype(np.float32)
        price = rng.uniform(0.05, 0.3, (D, TW)).astype(np.float32)
        fleet, out = ptwin.fleet_step_masked(
            fleet, _p_inputs(u, p, valid)[0],
            pstate.SimSlice(carbon_intensity=torch.from_numpy(ci), price=torch.from_numpy(price)),
            torch.from_numpy(active))
        jfleet, jout = jstep(jfleet, _j_inputs(u, p, valid)[0],
                             jstate.SimSlice(carbon_intensity=jnp.asarray(ci),
                                             price=jnp.asarray(price)),
                             jnp.asarray(active))
        _assert_out_matches(out, jout, active, f"resident window {w}")
        _assert_state_matches(fleet, jfleet, f"resident window {w}")


def test_run_fleet_matches_jax():
    """``run_fleet`` over [W, D] inputs against the JAX package's scan."""
    fleet, jfleet, _ = _fleets("joint_refine")
    ws = _windows(14, 4)
    u = np.stack([x[0] for x in ws])
    p = np.stack([x[1] for x in ws])
    valid = np.stack([x[2] for x in ws])
    final, outs = ptwin.run_fleet(
        fleet, pstate.TelemetrySlice(torch.from_numpy(u), torch.from_numpy(p),
                                     torch.from_numpy(valid)),
        pstate.SimSlice(u_th=torch.from_numpy(u)))
    jfinal, jouts = jtwin.run_fleet(
        jfleet, jstate.TelemetrySlice(jnp.asarray(u), jnp.asarray(p), jnp.asarray(valid)),
        jstate.SimSlice(u_th=jnp.asarray(u)))
    assert outs.mape.shape == (len(ws), D)
    _assert_out_matches(outs, jouts, slice(None), "run_fleet", refined=True)
    _assert_state_matches(final, jfinal, "run_fleet", refined=True)


@pytest.mark.parametrize("name,refine,per_host", [
    ("r_only", 0, False), ("joint_refine", 1, False), ("per_host", 0, True)])
def test_one_readout_and_one_calib_call_a_round(monkeypatch, name, refine, per_host):
    """One step calls ``ops.des_readout`` once and ``ops.calib_mape_grid``
    ``1 + refine_iters`` times (+1 per host), whatever the fill."""
    calls = {"des_readout": 0, "calib_mape_grid": 0}

    def counted(fn_name):
        fn = getattr(ops, fn_name)

        def wrapper(*a, **kw):
            calls[fn_name] += 1
            return fn(*a, **kw)
        return wrapper

    for k in calls:
        monkeypatch.setattr(ops, k, counted(k))
    fleet, _, _ = _fleets(name)
    for u, p, valid, active in _windows(15, 3):
        for k in calls:
            calls[k] = 0
        fleet, _ = ptwin.fleet_step_masked(fleet, *_p_inputs(u, p, valid),
                                           torch.from_numpy(active))
        assert calls == {"des_readout": 1,
                         "calib_mape_grid": 1 + refine + int(per_host)}, calls


# -- stacking and lane updates (ports of tests/test_twin_core.py) -------------

CFG_SMALL, _ = _cfgs("r_only")


def test_stack_twin_states_rejects_mixed_configs():
    other = pstate.TwinConfig(bins_per_window=24, dc=DC, calibrate=False, device="cpu")
    with pytest.raises(ValueError, match="TwinConfig"):
        ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL),
                                 pstate.init_twin_state(other)])


def test_stack_twin_states_names_leaf_and_lane_on_shape_mismatch():
    small = pstate.init_twin_state(pstate.TwinConfig(
        bins_per_window=24, dc=DatacenterConfig(num_hosts=4, cores_per_host=4), device="cpu"))
    mismatched = dataclasses.replace(small, cfg=CFG_SMALL)
    with pytest.raises(ValueError, match=r"hist_u.*lane 2"):
        ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL),
                                 pstate.init_twin_state(CFG_SMALL), mismatched])


def test_stack_twin_states_rejects_mixed_sim_u_presence():
    with_sim = dataclasses.replace(pstate.init_twin_state(CFG_SMALL),
                                   sim_u=torch.zeros((24, H)))
    with pytest.raises(ValueError, match=r"lane 1.*sim_u"):
        ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL), with_sim])
    with pytest.raises(ValueError, match="at least one"):
        ptwin.stack_twin_states([])


def test_update_twin_state_lane_names_leaf_and_lane():
    fleet = ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL)] * 3)
    bad = dataclasses.replace(
        pstate.init_twin_state(pstate.TwinConfig(
            bins_per_window=24, dc=DatacenterConfig(num_hosts=4, cores_per_host=4),
            device="cpu")),
        cfg=CFG_SMALL)
    with pytest.raises(ValueError, match=r"lane 2.*leaf hist_u"):
        ptwin.update_twin_state_lane(fleet, 2, bad)
    with pytest.raises(ValueError, match="TwinConfig"):
        ptwin.update_twin_state_lane(fleet, 0, pstate.init_twin_state(
            dataclasses.replace(CFG_SMALL, calibrate=False)))


def test_update_twin_state_lane_leaves_the_fleet_and_its_views_alone():
    """A lane update returns new tensors: the old fleet, and a lane view
    taken from it before, keep their values (what a dispatched batch holds)."""
    fleet = ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL)] * 3)
    view = ptwin.index_twin_state(fleet, 1)
    other = pstate.init_twin_state(CFG_SMALL, PowerParams(p_idle=50.0, p_max=250.0, r=3.0))
    new = ptwin.update_twin_state_lane(fleet, 1, other)
    assert float(new.params.r[1]) == 3.0 and float(fleet.params.r[1]) == 2.0
    assert float(view.params.r) == 2.0
    assert torch.equal(new.cand.r[1], other.cand.r) and torch.equal(new.cand.r[0], fleet.cand.r[0])


def test_update_twin_state_lane_in_place_writes_the_fleets_own_tensors():
    """``in_place=True`` writes lane i of the fleet's own tensors and
    returns the fleet: the other lanes keep their values, and the result
    equals the out-of-place update."""
    fleet = ptwin.stack_twin_states([pstate.init_twin_state(CFG_SMALL)] * 3)
    other = pstate.init_twin_state(CFG_SMALL, PowerParams(p_idle=50.0, p_max=250.0, r=3.0))
    want = ptwin.update_twin_state_lane(fleet, 1, other)
    ptrs = [x.data_ptr() for x in pstate.state_leaves(fleet)]
    got = ptwin.update_twin_state_lane(fleet, 1, other, in_place=True)
    assert got is fleet
    assert [x.data_ptr() for x in pstate.state_leaves(got)] == ptrs
    for a, b in zip(pstate.state_leaves(got), pstate.state_leaves(want)):
        assert torch.equal(a, b)
    assert float(fleet.params.r[0]) == 2.0 and float(fleet.params.r[1]) == 3.0


@pytest.mark.parametrize("n", [2, 5, 12, 16, 64])
def test_refine_weights_are_the_cpus_true_division(n):
    """A refine round's grid weights are formed on the host by true
    division: the CPU's own ``arange / (n - 1)``, bit for bit, so the CPU's
    grids are as before and the card's equal them."""
    from repro_torch.core.calibrate import _weights

    w = _weights(n, torch.device("cpu"))
    step = torch.arange(n, dtype=torch.float32) / (n - 1)
    assert torch.equal(w[1], step) and torch.equal(w[0], 1.0 - step)
