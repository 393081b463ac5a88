"""The port's persistence against the JAX package's.

``repro_torch.core.codec`` carries its own MessagePack writer and reader,
so the port needs no ``msgpack``: its bytes must be ``msgpack.packb(...,
use_bin_type=True)``'s on every payload the twin writes, and a state, a
telemetry flush and a cached window result must cross between the two
packages in both directions, dtype for dtype.  Under the zlib codec the
port's state blob is the JAX package's, byte for byte.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.core import codec as jcodec  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.calibrate import CalibrationSpec as JCalibrationSpec  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.core.telemetry import TelemetryStore as JTelemetryStore  # noqa: E402
from repro.core.telemetry import TelemetryWindow as JTelemetryWindow  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro.traces.thermal import PUEParams as JPUEParams  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import codec  # noqa: E402
from repro_torch.core import state as pstate  # noqa: E402
from repro_torch.core.calibrate import CalibrationSpec  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator, OrchestratorConfig  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.core.telemetry import TelemetryStore, TelemetryWindow, clip_to_window  # noqa: E402
from repro_torch.core.twin import TraceGroundTruth  # noqa: E402
from repro_torch.serve import cache as pcache  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like  # noqa: E402
from repro_torch.traces.thermal import PUEParams  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
DC_SMALL = DatacenterConfig(num_hosts=8, cores_per_host=4)
JDC_SMALL = JDatacenterConfig(num_hosts=8, cores_per_host=4)
CFG_SMALL = pstate.TwinConfig(bins_per_window=12, dc=DC_SMALL, device="cpu")


@pytest.fixture
def zlib_only(monkeypatch):
    """Both packages write zlib, whatever this environment has."""
    monkeypatch.setattr(codec, "HAVE_ZSTD", False)
    monkeypatch.setattr(jcodec, "HAVE_ZSTD", False)


def _telem(seed, t=12, h=8):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (t, h)).astype(np.float32)
    p = rng.uniform(1e3, 3e3, (t,)).astype(np.float32)
    return u, p


def _j_stepped(jcfg, windows=3, **init):
    """A JAX state after a few windows (calibrated parameters, history)."""
    st = jstate.init_twin_state(jcfg, **init)
    for w in range(windows):
        u, p = _telem(w, jcfg.bins_per_window, jcfg.dc.num_hosts)
        sim = jstate.SimSlice() if jcfg.sim_bins else jstate.SimSlice(u_th=jnp.asarray(u))
        st, _ = jax.jit(jstate.twin_step)(st, jstate.make_telemetry(u, p), sim)
    return st


def _port_cfg(jcfg):
    """The port's TwinConfig of a JAX one (device: the CPU)."""
    return pstate.TwinConfig(
        bins_per_window=jcfg.bins_per_window, dc=DatacenterConfig(**dataclasses.asdict(jcfg.dc)),
        calibration=CalibrationSpec(**dataclasses.asdict(jcfg.calibration)),
        calibrate=jcfg.calibrate, history_windows=jcfg.history_windows,
        power_model=jcfg.power_model, device="cpu",
        pue=None if jcfg.pue is None else PUEParams(**dataclasses.asdict(jcfg.pue)),
        sim_bins=jcfg.sim_bins)


def _assert_leaves_equal(port_state, jax_leaves):
    got = pstate.state_leaves(port_state)
    assert len(got) == len(jax_leaves)
    for name, a, b in zip(pstate.state_leaf_names(port_state), got, jax_leaves):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- the MessagePack subset ------------------------------------------------

_SCALARS = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
            2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768,
            -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, float("inf"),
            np.float64(2.5), "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
            "é" * 40, "a" * 70000, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
            [], list(range(15)), list(range(16)), list(range(70000)), (1, 2), {},
            {i: i for i in range(15)}, {i: str(i) for i in range(16)},
            {i: None for i in range(70000)}, {"a": [1, {"b": b"c", 3: -4.25}]}]


@pytest.mark.parametrize("value", _SCALARS, ids=lambda v: type(v).__name__ + str(v)[:12])
def test_msgpack_subset_bytes_and_round_trip(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert codec.packb(value) == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False, strict_map_key=False)


def test_msgpack_subset_refuses_what_msgpack_refuses():
    for bad in (np.int64(3), np.float32(1.0), np.bool_(True), object()):
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True)
        with pytest.raises(TypeError):
            codec.packb(bad)
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)
    with pytest.raises(ValueError, match="extra data"):
        codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb("abc")[:-1])


def _raw(blob):
    return jcodec.decompress(blob)


def test_every_payload_the_codec_emits_matches_msgpack(tmp_path):
    """A JAX state (per-host, with sim_u and a PUE model), a telemetry flush
    with int window keys and a cached window result: the port's writer
    reproduces each payload's bytes, and its reader reads them as msgpack
    does."""
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, sim_bins=36,
                             calibration=JCalibrationSpec(per_host=True),
                             pue=JPUEParams(base=1.2, load_coeff=0.1))
    sim_u = np.random.default_rng(1).uniform(0, 1, (36, 8)).astype(np.float32)
    jst = _j_stepped(jcfg, sim_u=sim_u)
    store = JTelemetryStore(bins_per_window=4)
    for w in range(3):
        u, p = _telem(w, 4, 2)
        store.ingest(JTelemetryWindow(window=w, t0_bin=4 * w, u_th=u, power_w=p.astype(np.float64),
                                      extras={"price": p}))
    path = str(tmp_path / "telemetry.bin")
    store.flush(path)
    u, p = _telem(9)
    st, out = jax.jit(jstate.twin_step)(jst, jstate.make_telemetry(u, p), jstate.SimSlice())
    out = jax.tree.map(np.asarray, out)
    for raw in (_raw(jstate.state_to_bytes(jst)), _raw(open(path, "rb").read()),
                _raw(jcache.encode_result(out, st))):
        obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert codec.packb(obj) == raw
        assert codec.unpackb(raw) == obj


# -- codec ids ---------------------------------------------------------------

def test_codec_zlib_round_trip():
    data = b"windowed telemetry " * 100
    blob = codec.compress(data, codec=codec.CODEC_ZLIB)
    assert blob[:1] == codec.CODEC_ZLIB
    assert codec.decompress(blob) == data
    assert jcodec.decompress(blob) == data


def test_codec_rejects_unknown_id():
    with pytest.raises(ValueError):
        codec.decompress(b"\x7fgarbage")
    with pytest.raises(ValueError):
        codec.decompress(b"")
    with pytest.raises(ValueError, match="unknown codec"):
        codec.compress(b"x", codec=b"\x7f")


def test_zstd_blob_without_zstandard_is_explicit(monkeypatch):
    monkeypatch.setattr(codec, "HAVE_ZSTD", False)
    with pytest.raises(RuntimeError, match="zstd"):
        codec.decompress(codec.CODEC_ZSTD + b"\x28\xb5\x2f\xfdxxxx")
    with pytest.raises(RuntimeError, match="zstd"):
        codec.decompress(b"\x28\xb5\x2f\xfdxxxx")          # a legacy raw frame
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        codec.compress(b"x", codec=codec.CODEC_ZSTD)
    assert codec.default_codec() == codec.CODEC_ZLIB


def test_zstd_blobs_and_legacy_frames_when_zstandard_is_present():
    if not codec.HAVE_ZSTD:
        pytest.skip("zstandard is not installed here")
    data = b"twin state " * 50
    blob = codec.compress(data)
    assert blob[:1] == codec.CODEC_ZSTD and codec.decompress(blob) == data
    assert jcodec.decompress(blob) == data
    assert codec.decompress(blob[1:]) == data             # untagged legacy frame


def test_imports_survive_missing_zstandard():
    """The port's codec imports and writes zlib with ``zstandard`` poisoned."""
    snippet = (
        "import sys\n"
        "sys.modules['zstandard'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch.core, repro_torch.serve\n"
        "from repro_torch.core import codec\n"
        "assert codec.HAVE_ZSTD is False\n"
        "assert codec.default_codec() == codec.CODEC_ZLIB\n"
        "assert codec.loads(codec.dumps({'a': [1, b'x']})) == {'a': [1, b'x']}\n"
        "print('IMPORT_OK')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                         text=True, timeout=120, env=env)
    assert "IMPORT_OK" in out.stdout, out.stdout + out.stderr


# -- states across the two packages -------------------------------------------

_STATE_CASES = {
    "default": dict(),
    "per_host": dict(calibration=JCalibrationSpec(per_host=True, refine_iters=1)),
    "sim_bins": dict(sim_bins=36),
    "joint_pue": dict(calibration=JCalibrationSpec(mode="joint", scale_points=4),
                      pue=JPUEParams(base=1.1, amb_coeff=0.02)),
}


def _j_case(name, windows):
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, **_STATE_CASES[name])
    init = {}
    if jcfg.sim_bins:
        init["sim_u"] = np.random.default_rng(5).uniform(0, 1, (36, 8)).astype(np.float32)
    if windows == 0:
        return jcfg, jstate.init_twin_state(
            jcfg, JPowerParams(p_idle=64.0, p_max=310.0, r=1.7), **init)
    return jcfg, _j_stepped(jcfg, windows, **init)


@pytest.mark.parametrize("windows", [0, 3])
@pytest.mark.parametrize("name", list(_STATE_CASES))
def test_state_bytes_equal_the_jax_packages_under_zlib(zlib_only, name, windows):
    """The port's blob of a state is the JAX package's blob of the same
    state, byte for byte; each loads in the other package dtype-exact."""
    jcfg, jst = _j_case(name, windows)
    pst = convert.twin_state_from_numpy(jax.tree_util.tree_leaves(jst), _port_cfg(jcfg))
    jblob, pblob = jstate.state_to_bytes(jst), pstate.state_to_bytes(pst)
    assert pblob[:1] == codec.CODEC_ZLIB
    assert pblob == jblob
    back = pstate.state_from_bytes(jblob, device="cpu")
    assert back.cfg == pst.cfg
    _assert_leaves_equal(back, jax.tree_util.tree_leaves(jst))
    jback = jstate.state_from_bytes(pblob)
    assert jback.cfg == jcfg
    _assert_leaves_equal(pst, jax.tree_util.tree_leaves(jback))


def test_port_init_state_bytes_equal_the_jax_packages(zlib_only):
    """Without any conversion: the port's own fresh state, default and
    per-host, writes the JAX package's bytes."""
    for spec, jspec in ((CalibrationSpec(), JCalibrationSpec()),
                        (CalibrationSpec(per_host=True), JCalibrationSpec(per_host=True))):
        pst = pstate.init_twin_state(dataclasses.replace(CFG_SMALL, calibration=spec),
                                     PowerParams(p_idle=64.0, p_max=310.0, r=1.7))
        jst = jstate.init_twin_state(
            jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, calibration=jspec),
            JPowerParams(p_idle=64.0, p_max=310.0, r=1.7))
        assert pstate.state_to_bytes(pst) == jstate.state_to_bytes(jst)


def test_state_blob_ignores_the_wire_backend_and_takes_the_callers_device():
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL, kernel_backend="pallas")
    blob = jstate.state_to_bytes(jstate.init_twin_state(jcfg))
    st = pstate.state_from_bytes(blob, device="cpu")
    assert st.cfg.device == "cpu" and st.hist_u.device.type == "cpu"
    assert codec.loads(pstate.state_to_bytes(st))["cfg"]["kernel_backend"] == "xla"
    bad = codec.dumps(dict(codec.loads(blob), version=2))
    with pytest.raises(ValueError, match="version"):
        pstate.state_from_bytes(bad, device="cpu")


def test_telemetry_store_crosses_both_packages_dtype_exact(tmp_path):
    """A JAX flush loads in the port and the port's flush loads in JAX: every
    column bit for bit with its own dtype; the legacy version-1 layout loads
    too."""
    rng = np.random.default_rng(0)
    windows = [dict(window=w, t0_bin=w * 4, u_th=rng.random((4, 2)).astype(np.float32),
                    power_w=rng.random(4).astype(np.float64) * 400.0,
                    extras={"carbon_intensity": rng.random(4).astype(np.float32),
                            "price": rng.random(4).astype(np.float64)})
               for w in range(3)]
    jstore, pstore = JTelemetryStore(bins_per_window=4), TelemetryStore(bins_per_window=4)
    for kw in windows:
        jstore.ingest(JTelemetryWindow(**kw))
        pstore.ingest(TelemetryWindow(**kw))
    jpath, ppath = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jstore.flush(jpath)
    pstore.flush(ppath)
    for loaded in (TelemetryStore.load(jpath), JTelemetryStore.load(ppath),
                   TelemetryStore.load(ppath)):
        assert loaded.bins_per_window == 4 and sorted(loaded.windows()) == [0, 1, 2]
        for w in range(3):
            a, b = pstore.get(w), loaded.get(w)
            assert b.t0_bin == a.t0_bin
            for x, y in [(a.u_th, b.u_th), (a.power_w, b.power_w),
                         *[(a.extras[k], b.extras[k]) for k in a.extras]]:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    legacy = {"bins_per_window": 4, "sample_seconds": 300.0, "windows": {
        w: {"t0_bin": 4 * w, "u_th": kw["u_th"].tobytes(), "u_shape": [4, 2],
            "power_w": kw["power_w"].tobytes(),
            "extras": {"price": {"b": kw["extras"]["price"].astype(np.float32).tobytes(),
                                 "s": [4]}}}
        for w, kw in enumerate(windows)}}
    lpath = tmp_path / "legacy.bin"
    lpath.write_bytes(codec.dumps(legacy))
    old = TelemetryStore.load(str(lpath))
    np.testing.assert_array_equal(old.get(2).u_th, windows[2]["u_th"])
    np.testing.assert_array_equal(old.get(2).power_w, windows[2]["power_w"])
    assert old.get(1).extras["price"].dtype == np.float32


def test_telemetry_store_round_trip_zlib(tmp_path, monkeypatch):
    monkeypatch.setattr(codec, "HAVE_ZSTD", False)
    rng = np.random.default_rng(0)
    store = TelemetryStore(bins_per_window=6)
    for win in range(3):
        store.ingest(clip_to_window(win, 6, win * 6, rng.random((6, 4)).astype(np.float32),
                                    rng.uniform(1e3, 2e3, 6),
                                    temp=rng.random(6).astype(np.float32)))
    path = str(tmp_path / "telemetry.bin")
    store.flush(path)
    with open(path, "rb") as f:
        assert f.read(1) == codec.CODEC_ZLIB
    loaded = TelemetryStore.load(path)
    assert sorted(loaded.windows()) == [0, 1, 2]
    for win in range(3):
        a, b = store.get(win), loaded.get(win)
        np.testing.assert_array_equal(a.u_th, b.u_th)
        np.testing.assert_array_equal(a.power_w, b.power_w)
        np.testing.assert_array_equal(a.extras["temp"], b.extras["temp"])


def test_checkpoint_round_trip_zlib(tmp_path, monkeypatch):
    """The port's checkpoint (``save_state``) under the zlib fallback."""
    monkeypatch.setattr(codec, "HAVE_ZSTD", False)
    st = pstate.init_twin_state(CFG_SMALL)
    u, p = _telem(3)
    st, _ = pstate.twin_step(st, pstate.make_telemetry(u, p, device="cpu"),
                             pstate.SimSlice(u_th=torch.from_numpy(u)))
    path = str(tmp_path / "s.ckpt")
    pstate.save_state(st, path)
    with open(path, "rb") as f:
        assert f.read(1) == codec.CODEC_ZLIB
    back = pstate.load_state(path, device="cpu")
    assert back.cfg == CFG_SMALL
    for a, b in zip(pstate.state_leaves(st), pstate.state_leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_cached_result_blobs_cross_both_packages():
    """A JAX result blob decodes in the port and the port's in JAX, output
    leaves and successor state bit for bit with their dtypes."""
    jcfg = jstate.TwinConfig(bins_per_window=12, dc=JDC_SMALL)
    jst = _j_stepped(jcfg, 2)
    u, p = _telem(7)
    jnext, jout = jax.jit(jstate.twin_step)(jst, jstate.make_telemetry(u, p),
                                            jstate.SimSlice(u_th=jnp.asarray(u)))
    jout = jax.tree.map(np.asarray, jout)
    out, st = pcache.decode_result(jcache.encode_result(jout, jnext), device="cpu")
    _assert_leaves_equal(st, jax.tree_util.tree_leaves(jnext))
    jleaves = jax.tree_util.tree_leaves(jout)
    pleaves = [x for x in (
        *(getattr(out.prediction, f) for f in pcache._PRED_FIELDS), out.mape, out.calib_mape,
        out.params_used.p_idle, out.params_used.p_max, out.params_used.r,
        out.params_next.p_idle, out.params_next.p_max, out.params_next.r, out.window)
        if x is not None]
    assert len(pleaves) == len(jleaves)
    for a, b in zip(pleaves, jleaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jout2, jst2 = jcache.decode_result(pcache.encode_result(out, st))
    for a, b in zip(jax.tree_util.tree_leaves(jout2), jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    _assert_leaves_equal(st, jax.tree_util.tree_leaves(jst2))
    assert pcache.digest_arrays(*pstate.state_leaves(st)) == \
        jcache.digest_arrays(*jax.tree_util.tree_leaves(jnext))


# -- checkpoint / resume (ports of tests/test_twin_core.py) ---------------------

def test_checkpoint_resume_reproduces_run_exactly(tmp_path):
    """Save the orchestrator's state halfway, restore into a fresh one: the
    resumed tail's MAPE and parameter streams and its final state equal
    the uninterrupted run's exactly."""
    days = 1.0
    dc = DatacenterConfig(num_hosts=24, cores_per_host=16)
    w = make_surf22_like(SurfTraceSpec(days=days, seed=13), dc, device="cpu")
    t_bins = int(days * BINS_PER_DAY)
    cfg = OrchestratorConfig(bins_per_window=36, device="cpu")
    truth = TraceGroundTruth(w, dc, t_bins)

    def run(orch, windows):
        for win in windows:
            orch.store.ingest(truth.window(win, cfg.bins_per_window))
            orch.run_window(win)

    full = Orchestrator(w, dc, t_bins, cfg)
    run(full, range(full.num_windows))
    cut = full.num_windows // 2
    first = Orchestrator(w, dc, t_bins, cfg)
    run(first, range(cut))
    path = str(tmp_path / "twin_state.ckpt")
    first.save_state(path)
    resumed = Orchestrator(w, dc, t_bins, cfg)
    resumed.restore_state(path)
    run(resumed, range(cut, full.num_windows))

    np.testing.assert_array_equal(np.array([r.mape for r in resumed.records]),
                                  np.array([r.mape for r in full.records[cut:]]))
    np.testing.assert_array_equal(
        np.array([float(r.params.r) for r in resumed.records]),
        np.array([float(r.params.r) for r in full.records[cut:]]))
    for a, b in zip(pstate.state_leaves(resumed.state), pstate.state_leaves(full.state)):
        assert torch.equal(a, b)


def test_restore_state_rejects_config_mismatch(tmp_path):
    st = pstate.init_twin_state(CFG_SMALL)
    path = str(tmp_path / "s.ckpt")
    pstate.save_state(st, path)
    assert pstate.load_state(path, device="cpu").cfg == CFG_SMALL
    dc = DatacenterConfig(num_hosts=8, cores_per_host=4)
    w_dummy = make_surf22_like(SurfTraceSpec(days=0.1, seed=1), dc, device="cpu")
    orch = Orchestrator(w_dummy, dc, 24, OrchestratorConfig(bins_per_window=24, device="cpu"))
    with pytest.raises(ValueError, match="TwinConfig"):
        orch.restore_state(path)


def test_sim_in_state_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    sim_u = rng.uniform(0, 1, (24, 8)).astype(np.float32)
    cfg = dataclasses.replace(CFG_SMALL, sim_bins=24)
    state = pstate.init_twin_state(cfg, sim_u=sim_u)
    u, p = _telem(2)
    state, _ = pstate.twin_step(state, pstate.make_telemetry(u, p, device="cpu"),
                                pstate.SimSlice())
    path = str(tmp_path / "sim.ckpt")
    pstate.save_state(state, path)
    back = pstate.load_state(path, device="cpu")
    assert back.cfg.sim_bins == 24
    for a, b in zip(pstate.state_leaves(state), pstate.state_leaves(back)):
        assert torch.equal(a, b)


def test_load_state_asks_for_the_card_by_default(tmp_path):
    """No quiet fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = str(tmp_path / "s.ckpt")
    pstate.save_state(pstate.init_twin_state(CFG_SMALL), path)
    with pytest.raises(RuntimeError, match="cuda"):
        pstate.load_state(path)
