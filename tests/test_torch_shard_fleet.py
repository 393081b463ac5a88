"""The port's fleet-axis sharding: lanes split over a mesh equal the
unsharded lanes bit for bit, and the JAX package's vmap path at the parity
bars.

Mirrors ``tests/test_shard_fleet.py`` case for case, at its sizes (8 hosts
x 4 cores, 12-bin windows), on CPU meshes of 1, 3 and 4 entries (a mesh
of repeated ``cpu`` is the port's counterpart of
``--xla_force_host_platform_device_count``): ``run_fleet``,
``fleet_step_masked`` and ``TwinService`` sharded against the port's own
unsharded path (``torch.equal`` on every leaf) and against the JAX
package's default path on the same seeded inputs (decisions and counts
exact, floats at rtol 5e-6); padding when D is not a multiple of the
entries and when there are fewer lanes than entries; kernel calls counted
per entry; a mesh without ``shard=True`` raising.  Then the port's mesh
plans (``runtime/elastic.py`` against the JAX ``plan_mesh``) and the
meshes' refusals: no card, no fallback.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import state as jstate  # noqa: E402
from repro.core import twin as jtwin  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SyntheticProducer as JSyntheticProducer  # noqa: E402
from repro.serve import TwinService as JTwinService  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro_torch.core import state as pstate  # noqa: E402
from repro_torch.core import twin as ptwin  # noqa: E402
from repro_torch.core.calibrate import CalibrationSpec  # noqa: E402
from repro_torch.core.scenarios import scenario_mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.serve import ServeConfig, TwinService  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402
from test_torch_fleet import _assert_out_matches, _assert_state_matches  # noqa: E402

DC = DatacenterConfig(num_hosts=8, cores_per_host=4)
CFG = pstate.TwinConfig(bins_per_window=12, dc=DC, device="cpu")
JCFG = jstate.TwinConfig(bins_per_window=12, dc=JDatacenterConfig(num_hosts=8, cores_per_host=4))
ENTRIES = (1, 3, 4)


def _telem(seed: int):
    r = np.random.default_rng(seed)
    u = r.uniform(0, 1, (12, 8)).astype(np.float32)
    p = (8 * 70 + 2240 * r.uniform(0.2, 0.9, 12)).astype(np.float32)
    return u, p


def _fleet_arrays(n_windows: int, n_dc: int):
    """``run_fleet`` inputs as numpy ``[W, D, ...]`` (lane d, window w keyed
    by seed ``100 * d + w``)."""
    us = np.stack([[_telem(100 * d + w)[0] for d in range(n_dc)] for w in range(n_windows)])
    ps = np.stack([[_telem(100 * d + w)[1] for d in range(n_dc)] for w in range(n_windows)])
    return us, ps, np.ones((n_windows, n_dc), bool)


def _step_arrays(n_dc: int, seed0: int = 0):
    """``fleet_step_masked`` inputs as numpy ``[D, ...]`` (one window)."""
    us = np.stack([_telem(seed0 + d)[0] for d in range(n_dc)])
    ps = np.stack([_telem(seed0 + d)[1] for d in range(n_dc)])
    return us, ps, np.ones((n_dc,), bool)


def _port(u, p, valid):
    return (pstate.TelemetrySlice(u_th=torch.from_numpy(u), power_w=torch.from_numpy(p),
                                  valid=torch.from_numpy(valid)),
            pstate.SimSlice(u_th=torch.from_numpy(u)))


def _jax(u, p, valid):
    return (jstate.TelemetrySlice(u_th=jnp.asarray(u), power_w=jnp.asarray(p),
                                  valid=jnp.asarray(valid)),
            jstate.SimSlice(u_th=jnp.asarray(u)))


def _fresh_fleet(d: int, cfg=CFG):
    return ptwin.stack_twin_states([pstate.init_twin_state(cfg) for _ in range(d)])


def _jfresh_fleet(d: int):
    return jtwin.stack_twin_states([jstate.init_twin_state(JCFG) for _ in range(d)])


def _tensors(x) -> list:
    """Every tensor (or numpy array, as a tensor) of a nested dataclass or
    tuple, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (np.ndarray, np.generic)):
        return [torch.from_numpy(np.asarray(x))]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) if f.name != "cfg"
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _as_torch(x):
    """A harvested (numpy) WindowOutput with tensor leaves."""
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.asarray(x))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _as_torch(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def _assert_bitwise(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb) and ta
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(x, y)


def _mesh(n: int):
    return ptwin.fleet_mesh(n, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run_fleet(d: int, w: int):
    us, ps, valid = _fleet_arrays(w, d)
    return jtwin.run_fleet(_jfresh_fleet(d), *_jax(us, ps, valid))


@pytest.mark.parametrize("n", ENTRIES)
def test_run_fleet_sharded_matches_unsharded_bitwise(n):
    """The gate: D=6 (not a multiple of 4, and padded to 2 lanes an entry
    on 4) split over ``n`` entries equals the unsharded run bit for bit,
    final states and every window's outputs; and the JAX package's
    ``run_fleet`` (its vmap path) at the parity bars."""
    d, w = 6, 3
    arrays = _fleet_arrays(w, d)
    ref = ptwin.run_fleet(_fresh_fleet(d), *_port(*arrays))
    sh = ptwin.run_fleet(_fresh_fleet(d), *_port(*arrays), shard=True, mesh=_mesh(n))
    _assert_bitwise(ref, sh)
    jfinal, jouts = _jax_run_fleet(d, w)
    _assert_out_matches(sh[1], jouts, slice(None), f"run_fleet over {n}")
    _assert_state_matches(sh[0], jfinal, f"run_fleet over {n}")


def test_run_fleet_sharded_matches_solo_lanes():
    """Every sharded lane is its solo ``twin_step`` stream: parameters and
    counts exact, floats at rtol 1e-6 (the bar of
    ``tests/test_torch_fleet.py``'s lane-against-solo test)."""
    d, w = 3, 2
    final, outs = ptwin.run_fleet(_fresh_fleet(d), *_port(*_fleet_arrays(w, d)),
                                  shard=True, mesh=_mesh(4))
    for dc_i in range(d):
        st = pstate.init_twin_state(CFG)
        for w_i in range(w):
            u, p = _telem(100 * dc_i + w_i)
            st, out = pstate.twin_step(st, pstate.make_telemetry(u, p, device="cpu"),
                                       pstate.SimSlice(u_th=torch.from_numpy(u)))
            torch.testing.assert_close(outs.mape[w_i, dc_i], out.mape, rtol=1e-6, atol=0)
            for f in ("p_idle", "p_max", "r"):
                assert torch.equal(getattr(outs.params_next, f)[w_i, dc_i],
                                   getattr(out.params_next, f))
        lane = ptwin.index_twin_state(final, dc_i)
        for name, a, b in zip(pstate.state_leaf_names(st), pstate.state_leaves(st),
                              pstate.state_leaves(lane)):
            if a.dtype == torch.int32 or name.startswith(("params", "hist")):
                assert torch.equal(a, b), (dc_i, name)


@pytest.mark.parametrize("n", ENTRIES)
def test_fleet_step_masked_sharded_matches_unsharded_bitwise(n):
    """The serving step with mixed fill: inactive lanes ride along
    unchanged, sharded equal to unsharded bit for bit, and the active lanes
    at the JAX package's masked step's bars."""
    d = 5
    u, p, valid = _step_arrays(d)
    active = np.array([True, False, True, True, False])
    ref = ptwin.fleet_step_masked(_fresh_fleet(d), *_port(u, p, valid),
                                  torch.from_numpy(active))
    sh = ptwin.fleet_step_masked(_fresh_fleet(d), *_port(u, p, valid),
                                 torch.from_numpy(active), shard=True, mesh=_mesh(n))
    _assert_bitwise(ref, sh)
    jfleet, jout = jax.jit(jtwin._fleet_step_masked)(_jfresh_fleet(d), *_jax(u, p, valid),
                                                     jnp.asarray(active))
    _assert_out_matches(sh[1], jout, active, f"masked step over {n}")
    _assert_state_matches(sh[0], jfleet, f"masked step over {n}")


@pytest.mark.parametrize("n", ENTRIES)
def test_explicit_mesh_and_padding(n):
    """D=5 pads on 3 and 4 entries with lane-0 replicas; both outputs come
    back with the true D, on the fleet's device."""
    mesh = _mesh(n)
    assert mesh.shape[ptwin.FLEET_AXIS] == n
    d, w = 5, 2
    arrays = _fleet_arrays(w, d)
    final, outs = ptwin.run_fleet(_fresh_fleet(d), *_port(*arrays), shard=True, mesh=mesh)
    assert outs.mape.shape == (w, d)
    assert all(x.shape[0] == d for x in pstate.state_leaves(final))
    _assert_bitwise(ptwin.run_fleet(_fresh_fleet(d), *_port(*arrays)), (final, outs))


@pytest.mark.parametrize("n", ENTRIES)
def test_one_lane_per_entry(n):
    """D equal to the entries (each entry padded to 2 lanes when there is
    more than one) matches the unsharded step bit for bit."""
    u, p, valid = _step_arrays(n, seed0=40)
    active = torch.ones((n,), dtype=torch.bool)
    ref = ptwin.fleet_step_masked(_fresh_fleet(n), *_port(u, p, valid), active)
    sh = ptwin.fleet_step_masked(_fresh_fleet(n), *_port(u, p, valid), active,
                                 shard=True, mesh=_mesh(n))
    _assert_bitwise(ref, sh)


@pytest.mark.parametrize("n", ENTRIES)
def test_resident_sim_and_forecast_columns_shard_with_their_lanes(n):
    """``sim_bins > 0`` (each lane slices its window from its own ``sim_u``,
    ``SimSlice.u_th`` absent) with per-lane carbon and price columns and a
    shared 0-d ``valid``: sharded equal to unsharded bit for bit."""
    cfg = dataclasses.replace(CFG, sim_bins=36)
    rng = np.random.default_rng(4)
    d = 5
    fleet = ptwin.stack_twin_states([pstate.init_twin_state(
        cfg, sim_u=rng.uniform(0, 1, (36, 8)).astype(np.float32)) for _ in range(d)])
    u, p, _ = _step_arrays(d, seed0=60)
    telem = pstate.TelemetrySlice(u_th=torch.from_numpy(u), power_w=torch.from_numpy(p),
                                  valid=torch.tensor(True))
    sims = pstate.SimSlice(
        carbon_intensity=torch.from_numpy(rng.uniform(100, 500, (d, 12)).astype(np.float32)),
        price=torch.from_numpy(rng.uniform(0.05, 0.3, (d, 12)).astype(np.float32)))
    for _ in range(2):
        ref = ptwin.fleet_step_masked(fleet, telem, sims)
        sh = ptwin.fleet_step_masked(fleet, telem, sims, shard=True, mesh=_mesh(n))
        _assert_bitwise(ref, sh)
        fleet = sh[0]


def _count_calls(monkeypatch, names=("des_readout", "calib_mape_grid")):
    """Each kernel wrapper's calls and the lanes of each (the CPU runs the
    plain versions, which count no launches)."""
    calls = {k: [] for k in names}

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*a, **kw):
            calls[name].append(a[0].shape[0])
            return fn(*a, **kw)
        return wrapper

    for name in names:
        monkeypatch.setattr(ops, name, counted(name))
    return calls


def test_lanes_really_split_over_the_entries(monkeypatch):
    """On 4 entries D=6 runs as four shards of 2 lanes (2 of them padding):
    the readout is called once an entry on 2 lanes, not once on 6."""
    calls = _count_calls(monkeypatch)
    d, w = 6, 2
    final, outs = ptwin.run_fleet(_fresh_fleet(d), *_port(*_fleet_arrays(w, d)),
                                  shard=True, mesh=_mesh(4))
    assert calls["des_readout"] == [2] * (4 * w)
    assert outs.mape.shape == (w, d) and torch.isfinite(outs.mape).all()


@pytest.mark.parametrize("n", ENTRIES)
def test_kernel_calls_counted_per_entry(monkeypatch, n):
    """The counterpart of the single-compilation gate: a sharded window
    calls the readout once and the calibration ``1 + refine_iters`` times
    an entry, and a warm rerun the same (nothing grows)."""
    calls = _count_calls(monkeypatch)
    cfg = dataclasses.replace(CFG, calibration=CalibrationSpec(
        mode="joint", r_points=16, scale_points=5, refine_iters=1))
    d, w = 4, 2
    arrays = _fleet_arrays(w, d)
    final, _ = ptwin.run_fleet(_fresh_fleet(d, cfg), *_port(*arrays), shard=True,
                               mesh=_mesh(n))
    want = {"des_readout": w * n, "calib_mape_grid": 2 * w * n}
    assert {k: len(v) for k, v in calls.items()} == want
    for v in calls.values():
        v.clear()
    ptwin.run_fleet(final, *_port(*arrays), shard=True, mesh=_mesh(n))
    assert {k: len(v) for k, v in calls.items()} == want


def _serve(shard: bool, mesh=None):
    """Three tenants of two windows through a 4-lane service on the JAX
    producers' events (the parity tests' inputs)."""
    dc = DatacenterConfig(num_hosts=4, cores_per_host=4)
    twin = pstate.TwinConfig(bins_per_window=6, dc=dc, device="cpu")
    svc = TwinService(ServeConfig(twin=twin, lanes=4, queue_capacity=64, shard=shard,
                                  mesh=mesh))
    return svc, _run_service(svc)


def _serve_events():
    events = []
    for i, t in enumerate(["a", "b", "c"]):
        events.extend(JSyntheticProducer(t, hosts=4, bins_per_window=6, num_windows=2,
                                         seed=i).poll(float("inf")))
    return sorted(events, key=lambda e: (e.window, e.tenant))


def _run_service(svc):
    for t in ["a", "b", "c"]:
        svc.admit(t)
    for ev in _serve_events():
        assert svc.submit(ev)
    svc.run_until_idle(pump=False)
    return {(r.tenant, r.window): r.output for r in svc.drain()}


@pytest.mark.parametrize("n", ENTRIES)
def test_serve_sharded_matches_unsharded(monkeypatch, n):
    """``TwinService`` with ``shard=True`` serves the unsharded stream bit
    for bit (a batch calls each kernel once an entry), and the JAX
    package's service at the parity bars."""
    _, ref = _serve(False)
    calls = _count_calls(monkeypatch)
    svc, sh = _serve(True, _mesh(n))
    assert ref.keys() == sh.keys() and len(ref) == 6
    for k in ref:
        _assert_bitwise(ref[k], sh[k])
    assert len(calls["des_readout"]) == svc.stats.batches * n
    assert len(calls["calib_mape_grid"]) == svc.stats.batches * n
    jtwin_cfg = jstate.TwinConfig(bins_per_window=6,
                                  dc=JDatacenterConfig(num_hosts=4, cores_per_host=4))
    want = _run_service(JTwinService(JServeConfig(twin=jtwin_cfg, lanes=4,
                                                  queue_capacity=64)))
    for k in ref:
        _assert_out_matches(_as_torch(sh[k]), want[k], ..., str(k))


def test_mesh_requires_shard_flag():
    mesh = _mesh(1)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        ServeConfig(twin=CFG, lanes=2, mesh=mesh)
    u, p, valid = _step_arrays(2)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        ptwin.fleet_step_masked(_fresh_fleet(2), *_port(u, p, valid), mesh=mesh)
    with pytest.raises(ValueError, match="mesh given but shard=False"):
        ptwin.run_fleet(_fresh_fleet(2), *_port(*_fleet_arrays(1, 2)), mesh=mesh)
    with pytest.raises(ValueError, match="1-D mesh over 'fleet'"):
        ptwin.run_fleet(_fresh_fleet(2), *_port(*_fleet_arrays(1, 2)), shard=True,
                        mesh=scenario_mesh(2, device="cpu"))


# -- mesh plans and meshes ------------------------------------------------------

PLAN_GRID = [(dev, tp, gb, pods)
             for dev in (1, 2, 3, 4, 7, 8, 16, 24, 256, 512)
             for tp in (1, 2, 4, 16)
             for gb in (1, 6, 8, 12, 64, 256)
             for pods in (1, 2)]


def _plan(mod, dev, tp, gb, pods):
    try:
        return dataclasses.astuple(mod.plan_mesh(dev, model_parallel=tp, global_batch=gb,
                                                 prefer_pods=pods))
    except RuntimeError as e:
        return ("RuntimeError", str(e))


def test_plan_mesh_matches_jax():
    """``plan_mesh`` over a grid of device counts, TP degrees, global
    batches and pods: the JAX package's answers, its refusals included."""
    refusals = 0
    for args in PLAN_GRID:
        got, want = _plan(elastic, *args), _plan(jelastic, *args)
        assert got == want, args
        refusals += got[0] == "RuntimeError"
    assert refusals > 0
    plan = elastic.plan_mesh(8, model_parallel=2, global_batch=12, prefer_pods=2)
    assert plan.data_shards == jelastic.plan_mesh(
        8, model_parallel=2, global_batch=12, prefer_pods=2).data_shards


def test_build_mesh_lays_a_plan_over_the_given_devices():
    plan = elastic.plan_mesh(6, model_parallel=2, global_batch=12, prefer_pods=1)
    mesh = elastic.build_mesh(plan, ["cpu"] * 8)
    assert mesh.shape == dict(zip(plan.axes, plan.shape)) == {"data": 3, "model": 2}
    assert mesh.size == 6 and all(d == torch.device("cpu") for d in mesh.devices)
    assert sharding.mesh_axis_size(mesh, ("data", "model")) == 6
    assert sharding.mesh_axis_size(mesh, "model") == 2
    assert sharding.mesh_axis_size(mesh, None) == 1
    with pytest.raises(ValueError, match="needs 6 devices"):
        elastic.build_mesh(plan, ["cpu"] * 4)


def test_meshes_have_no_fallback():
    """A card the host lacks raises, at every door: no mesh falls back to
    the CPU or to fewer devices."""
    host = launch_mesh.make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        for make in (lambda: ptwin.fleet_mesh(), lambda: scenario_mesh(),
                     lambda: launch_mesh.make_host_mesh(),
                     lambda: sharding.make_mesh_compat((1,), ("fleet",), devices=["cuda:0"])):
            with pytest.raises(RuntimeError, match="is_available"):
                make()
    with pytest.raises(RuntimeError, match="need 256 cards"):
        launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 cards"):
        launch_mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="at least one device"):
        ptwin.fleet_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        sharding.make_mesh_compat((1, 1), ("a", "a"), devices=["cpu"])
