"""The port's streaming twin service (``repro_torch.serve``) on the CPU.

Ports of ``tests/test_serve.py`` held against the port's own solo
``twin_step`` (parameters exact, floats within rtol 1e-6), the 64-tenant
interleaved run held against the JAX package's ``TwinService`` window for
window on the same events (parameters exact, floats within rtol 5e-6, the
same cache keys), the producers' events against the JAX producers', and a
cache hit landing on a lane whose earlier window is still in flight.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import state as jstate  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SyntheticProducer as JSyntheticProducer  # noqa: E402
from repro.serve import TraceReplayProducer as JTraceReplayProducer  # noqa: E402
from repro.serve import TwinService as JTwinService  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro_torch.core import state as pstate  # noqa: E402
from repro_torch.core.orchestrator import Clock  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.core.telemetry import TelemetryStore, TelemetryWindow  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    LaneMap,
    ResultCache,
    ServeConfig,
    SyntheticProducer,
    TraceReplayProducer,
    TwinService,
    WindowManager,
    build_fleet_inputs,
)
from repro_torch.serve import cache as pcache  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402

DC = DatacenterConfig(num_hosts=4, cores_per_host=4)
TWIN = pstate.TwinConfig(bins_per_window=6, dc=DC, device="cpu")
JTWIN = jstate.TwinConfig(bins_per_window=6, dc=JDatacenterConfig(num_hosts=4, cores_per_host=4))
FLOAT_RTOL = 5e-6


def _producer(tenant, seed, num_windows=3, **kw):
    return SyntheticProducer(tenant, hosts=DC.num_hosts,
                             bins_per_window=TWIN.bins_per_window,
                             num_windows=num_windows, seed=seed, **kw)


def _all_events(producer):
    evs = producer.poll(float("inf"))
    assert producer.exhausted
    return evs


def _solo_outputs(events, cfg=TWIN, base=PowerParams()):
    """Reference stream: one tenant's windows through the port's solo
    twin_step, outputs on the host."""
    state = pstate.init_twin_state(cfg, base)
    outs = {}
    for ev in sorted(events, key=lambda e: e.window):
        state, out = pstate.twin_step(
            state, pstate.make_telemetry(ev.u_th, ev.power_w, device="cpu"),
            pstate.SimSlice(u_th=torch.from_numpy(ev.sim_u)))
        outs[ev.window] = out
    return outs, state


def _leaves(out):
    """A WindowOutput's leaves (tensors or arrays) as numpy, in order, with
    their names; None for an absent leaf."""
    pred = [(f"prediction.{f.name}", getattr(out.prediction, f.name))
            for f in dataclasses.fields(out.prediction)]
    rest = [("mape", out.mape), ("calib_mape", out.calib_mape)]
    for g in ("params_used", "params_next"):
        rest += [(f"{g}.{f}", getattr(getattr(out, g), f)) for f in ("p_idle", "p_max", "r")]
    rest.append(("window", out.window))
    return [(n, None if x is None else
             (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)))
            for n, x in pred + rest]


def _assert_output_close(got, want, rtol, ctx=""):
    """Parameters and window exact, every other leaf within ``rtol``, the
    same absent leaves."""
    for (n, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert (a is None) == (b is None), (ctx, n)
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, n)
        if n.startswith("params") or n == "window":
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {n}")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, equal_nan=True,
                                       err_msg=f"{ctx} {n}")


def _count_kernel_calls(monkeypatch):
    """Count the kernel wrappers' calls (the CPU runs their plain versions,
    which do not count launches)."""
    calls = {"des_readout": 0, "calib_mape_grid": 0}

    def counted(name):
        fn = getattr(ops, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    return calls


def _interleaved(streams, svc, chunk=40, seed=42):
    """Every tenant-window shuffled together, submitted in chunks with
    serving in between (so fill varies and repeated streams hit the cache)."""
    flat = [ev for evs in streams.values() for ev in evs]
    rng = np.random.default_rng(seed)
    rng.shuffle(flat)
    for i in range(0, len(flat), chunk):
        for ev in flat[i:i + chunk]:
            assert svc.submit(ev)
        svc.run_until_idle(pump=False)
    return svc.drain()


def test_64_tenants_interleaved_match_solo_and_one_batched_step(monkeypatch):
    """64 tenants, arbitrary arrival, partial batches: every emitted window
    (computed or cached) equals that tenant's solo stream, streams stay in
    order, and every batch calls the readout and the calibration once."""
    tenants = [f"t{i:02d}" for i in range(64)]
    streams = {t: _all_events(_producer(t, seed=i % 8)) for i, t in enumerate(tenants)}
    calls = _count_kernel_calls(monkeypatch)
    svc = TwinService(ServeConfig(twin=TWIN, lanes=64, queue_capacity=1024))
    for t in tenants:
        svc.admit(t)
    results = _interleaved(streams, svc)

    assert svc.compile_count() is None
    assert calls == {"des_readout": svc.stats.batches, "calib_mape_grid": svc.stats.batches}
    assert svc.stats.windows_served == 64 * 3
    assert svc.stats.windows_cached > 0, "identical streams never hit cache"
    assert svc.stats.batches >= 3
    assert 0 < svc.stats.fill_ratio < 1
    by_tenant = {}
    for r in results:
        by_tenant.setdefault(r.tenant, []).append(r)
    refs = {s: _solo_outputs(streams[f"t{s:02d}"])[0] for s in range(8)}
    for i, t in enumerate(tenants):
        rs = by_tenant[t]
        assert [r.window for r in rs] == [0, 1, 2], "stream order broken"
        for r in rs:
            _assert_output_close(r.output, refs[i % 8][r.window], 1e-6, f"{t} w{r.window}")


def test_64_tenants_match_the_jax_service_window_for_window():
    """The same 64 tenants through both packages' services on the JAX
    producers' events: the same windows emitted, cached and computed alike,
    parameters exact and floats within rtol 5e-6, and the same cache keys
    (the stream digests agree)."""
    tenants = [f"t{i:02d}" for i in range(64)]
    streams = {t: JSyntheticProducer(t, hosts=4, bins_per_window=6, num_windows=3,
                                     seed=i % 8).poll(float("inf"))
               for i, t in enumerate(tenants)}
    psvc = TwinService(ServeConfig(twin=TWIN, lanes=64, queue_capacity=1024))
    jsvc = JTwinService(JServeConfig(twin=JTWIN, lanes=64, queue_capacity=1024))
    for t in tenants:
        psvc.admit(t)
        jsvc.admit(t)
    got = {(r.tenant, r.window): r for r in _interleaved(streams, psvc)}
    want = {(r.tenant, r.window): r for r in _interleaved(streams, jsvc)}
    assert set(got) == set(want) and len(got) == 64 * 3
    for key, r in got.items():
        assert r.cached == want[key].cached, key
        _assert_output_close(r.output, want[key].output, FLOAT_RTOL, str(key))
    assert set(psvc.cache._entries) == set(jsvc.cache._entries)
    for f in ("windows_cached", "windows_computed", "batches", "lanes_stepped"):
        assert getattr(psvc.stats, f) == getattr(jsvc.stats, f), f


def test_state_digest_equals_the_jax_packages():
    """Admission digests a state's leaves: the port's digest of a state is
    the JAX package's digest of the same state."""
    base = PowerParams(p_idle=61.0, p_max=333.0, r=2.2)
    st = pstate.init_twin_state(TWIN, base)
    jst = jstate.init_twin_state(JTWIN, jstate.PowerParams(p_idle=61.0, p_max=333.0, r=2.2))
    ev = _all_events(_producer("d", seed=3, num_windows=1))[0]
    st, _ = pstate.twin_step(st, pstate.make_telemetry(ev.u_th, ev.power_w, device="cpu"),
                             pstate.SimSlice(u_th=torch.from_numpy(ev.sim_u)))
    jst, _ = jax.jit(jstate.twin_step)(jst, jstate.make_telemetry(ev.u_th, ev.power_w),
                                       jstate.SimSlice(u_th=jnp.asarray(ev.sim_u)))
    assert pcache.digest_arrays(*pstate.state_leaves(st)) == \
        jcache.digest_arrays(*jax.tree_util.tree_leaves(jst))
    assert pcache.digest_arrays(ev.u_th, None, ev.sim_u) == \
        jcache.digest_arrays(ev.u_th, None, ev.sim_u)


def test_producers_match_the_jax_producers():
    """The trace replay's events equal the JAX producer's bit for bit, and
    so do the synthetic producer's utilization and schedule.  The synthetic
    measured power is the numpy power model's, within two float32 ulps of
    the JAX model's (XLA's pow rounds otherwise than the C library's)."""
    rng = np.random.default_rng(2)

    class Truth:
        u_th = rng.uniform(0, 1, (36, 4)).astype(np.float32)
        power = rng.uniform(1e3, 2e3, 36)

    ci = rng.uniform(100, 500, 36).astype(np.float32)
    kw = dict(period_s=10.0, jitter_s=3.0, seed=5)
    pairs = [(TraceReplayProducer("a", Truth, 6, carbon_intensity=ci, **kw),
              JTraceReplayProducer("a", Truth, 6, carbon_intensity=ci, **kw))]
    pairs += [(SyntheticProducer("s", hosts=4, bins_per_window=6, num_windows=5,
                                 util_mean=0.3 + 0.02 * s, **dict(kw, seed=s)),
               JSyntheticProducer("s", hosts=4, bins_per_window=6, num_windows=5,
                                  util_mean=0.3 + 0.02 * s, **dict(kw, seed=s)))
              for s in range(8)]
    for p, j in pairs:
        for now in (25.0, 40.0, float("inf")):
            a, b = p.poll(now), j.poll(now)
            assert [e.window for e in a] == [e.window for e in b]
            for x, y in zip(a, b):
                for f in ("u_th", "sim_u", "carbon_intensity", "ambient_c", "price"):
                    xa, ya = getattr(x, f), getattr(y, f)
                    assert (xa is None) == (ya is None)
                    if xa is not None:
                        assert xa.dtype == ya.dtype
                        np.testing.assert_array_equal(xa, ya)
                if isinstance(p, TraceReplayProducer):
                    np.testing.assert_array_equal(x.power_w, y.power_w)
                else:
                    assert x.power_w.dtype == y.power_w.dtype == np.float32
                    np.testing.assert_array_max_ulp(x.power_w, y.power_w, maxulp=2)
        assert p.exhausted and j.exhausted


def test_cache_hit_on_a_lane_with_a_batch_in_flight_keeps_that_batch():
    """Tenant "x" repeats "y"'s stream.  With windows 0-1 of "y" dropped
    from the cache, "x" computes windows 0 and 1 and takes window 2 from the
    cache while its window-1 batch is still in flight (``inflight_depth=1``):
    landing the cached successor on the lane must not reach into that
    batch, whose window-1 output and cached successor state stay the solo
    run's."""
    events = _all_events(_producer("y", seed=4, num_windows=4))
    ref, final = _solo_outputs(events)
    warm = TwinService(ServeConfig(twin=TWIN, lanes=2))
    warm.admit("y")
    for ev in events:
        warm.submit(ev)
    warm.run_until_idle(pump=False)
    for key in [k for k in warm.cache._entries if k[0] < 2]:
        del warm.cache._entries[key]

    svc = TwinService(ServeConfig(twin=TWIN, lanes=2, inflight_depth=1))
    svc.cache = warm.cache
    svc.admit("x")
    svc.admit("z")
    x_events = [dataclasses.replace(ev, tenant="x") for ev in events]
    z_events = _all_events(_producer("z", seed=9, num_windows=4))
    hits_before = svc.cache.hits
    for ev in x_events[:3] + z_events[:3]:
        svc.submit(ev)
    assert svc._step_once() and len(svc._inflight) == 1      # x w0 (+ z w0) in flight
    assert svc._step_once() and len(svc._inflight) == 1      # x w1 dispatched, w0 harvested
    in_flight = svc._inflight[0]
    assert [e[0] for e in in_flight.entries] == ["x", "z"]
    svc._step_once()                                         # x w2: a hit; z w2 computed
    assert svc.cache.hits == hits_before + 1
    svc.submit(x_events[3])
    results = svc.run_until_idle(pump=False) + svc.drain()
    got = {r.window: r for r in results if r.tenant == "x"}
    assert sorted(got) == [0, 1, 2, 3] and got[2].cached and not got[1].cached
    for w, r in got.items():
        _assert_output_close(r.output, ref[w], 1e-6, f"x w{w}")
    # the window-1 successor cached from the in-flight batch is the solo one
    solo1 = _solo_outputs(events[:2])[1]
    states = [pcache.decode_result(blob, device="cpu")[1]
              for k, blob in svc.cache._entries.items() if k[0] == 1]
    assert any(all(torch.equal(a, b) for a, b in zip(pstate.state_leaves(s),
                                                     pstate.state_leaves(solo1)))
               for s in states)
    lane = svc.evict("x").state
    for a, b in zip(pstate.state_leaves(lane), pstate.state_leaves(final)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_lane_writes_copy_the_fleet_only_while_a_batch_holds_it():
    """An admission with no batch in flight writes the fleet's own tensors;
    a lane write while a batch holds the fleet goes to a copy (once), and
    the batch's fleet keeps its values."""
    svc = TwinService(ServeConfig(twin=TWIN, lanes=3, inflight_depth=1))
    fleet = svc._fleet
    svc.admit("a")
    assert svc._fleet is fleet
    events = _all_events(_producer("a", seed=2, num_windows=1))
    svc.submit(events[0])
    svc._step_once()
    held = svc._inflight[0].fleet
    assert held is svc._fleet
    before = [x.clone() for x in pstate.state_leaves(held)]
    other = pstate.init_twin_state(TWIN, PowerParams(p_idle=50.0, p_max=250.0, r=3.0))
    svc.admit("b", other)
    copied = svc._fleet
    assert copied is not held
    svc.admit("c", other)
    assert svc._fleet is copied
    for a, b in zip(pstate.state_leaves(held), before):
        assert torch.equal(a, b)
    assert float(copied.params.r[1]) == 3.0 and float(copied.params.r[2]) == 3.0


def test_build_fleet_inputs_checks_shapes_and_columns():
    ev = _all_events(_producer("a", seed=0, num_windows=1))[0]
    telem, sim, active = build_fleet_inputs({1: ev}, 3, TWIN)
    assert active.tolist() == [False, True, False]
    assert telem.valid.tolist() == [False, True, False]
    assert torch.equal(telem.u_th[1], torch.from_numpy(ev.u_th)) and sim.price is None
    with pytest.raises(ValueError, match="carbon_intensity"):
        build_fleet_inputs({0: ev}, 2, TWIN, columns=("carbon_intensity",))
    with pytest.raises(ValueError, match="compiled for|clip"):
        build_fleet_inputs({0: dataclasses.replace(ev, u_th=ev.u_th[:3])}, 2, TWIN)
    with pytest.raises(ValueError, match="unknown sim columns"):
        ServeConfig(twin=TWIN, columns=("humidity",))


# -- ports of tests/test_serve.py ------------------------------------------------

def test_kill_and_restore_equals_uninterrupted(tmp_path):
    tenants = {f"s{i}": i % 3 for i in range(6)}   # seed reuse -> cache hits
    streams = {t: _all_events(_producer(t, seed=s, num_windows=4))
               for t, s in tenants.items()}

    def submit_all(svc, events):
        rng = np.random.default_rng(7)
        events = list(events)
        rng.shuffle(events)
        for ev in events:
            assert svc.submit(ev)
        return svc.run_until_idle(pump=False)

    ref_svc = TwinService(ServeConfig(twin=TWIN, lanes=8, queue_capacity=64))
    for t in tenants:
        ref_svc.admit(t)
    ref = {(r.tenant, r.window): r
           for r in submit_all(ref_svc, [ev for evs in streams.values() for ev in evs])}

    svc_a = TwinService(ServeConfig(twin=TWIN, lanes=8, queue_capacity=64))
    for t in tenants:
        svc_a.admit(t)
    got_a = submit_all(svc_a, [ev for evs in streams.values() for ev in evs if ev.window < 2])
    svc_a.checkpoint(tmp_path / "sessions")
    del svc_a

    svc_b = TwinService(ServeConfig(twin=TWIN, lanes=8, queue_capacity=64))
    assert sorted(svc_b.restore(tmp_path / "sessions")) == sorted(tenants)
    for t, s in tenants.items():
        svc_b.attach(_producer(t, seed=s, num_windows=4))
    got_b = svc_b.run_until_idle()

    assert svc_b.stats.stale_dropped == len(tenants) * 2
    combined = {(r.tenant, r.window): r for r in got_a + got_b}
    assert set(combined) == set(ref)
    for key, r in combined.items():
        _assert_output_close(r.output, ref[key].output, 0.0, str(key))


def test_backpressure_rewinds_producer_losslessly():
    svc = TwinService(ServeConfig(twin=TWIN, lanes=2, queue_capacity=2))
    svc.admit("bp")
    svc.attach(_producer("bp", seed=5, num_windows=6))
    results = svc.run_until_idle()

    assert svc.stats.queue_rejects > 0, "queue never filled — weak test"
    assert [r.window for r in results] == list(range(6))
    ref, _ = _solo_outputs(_all_events(_producer("bp", seed=5, num_windows=6)))
    for r in results:
        _assert_output_close(r.output, ref[r.window], 1e-6, f"window {r.window}")


def test_evict_readmit_continues_stream_exactly():
    events = _all_events(_producer("ev", seed=9, num_windows=4))
    ref, _ = _solo_outputs(events)

    svc = TwinService(ServeConfig(twin=TWIN, lanes=2))
    svc.admit("ev")
    for e in events[:2]:
        svc.submit(e)
    first = svc.run_until_idle(pump=False)

    session = svc.evict("ev")
    assert "ev" not in svc.tenants
    svc.admit("other")  # lane reuse while 'ev' is away
    svc.admit("ev", session.state, digest=session.digest,
              next_window=session.next_window)
    for e in events[2:]:
        svc.submit(e)
    rest = svc.run_until_idle(pump=False)

    got = {r.window: r for r in first + rest if r.tenant == "ev"}
    assert sorted(got) == [0, 1, 2, 3]
    for w, r in got.items():
        _assert_output_close(r.output, ref[w], 1e-6, f"window {w}")


def test_live_mode_injected_clock():
    class FakeTime:
        def __init__(self):
            self.t = 0.0
            self.lock = threading.Lock()

        def now(self):
            with self.lock:
                return self.t

        def sleep(self, s):
            with self.lock:
                self.t += s

    ft = FakeTime()
    svc = TwinService(ServeConfig(twin=TWIN, lanes=2, poll_seconds=10.0),
                      clock=Clock(now=ft.now, sleep=ft.sleep))
    svc.admit("live")
    svc.attach(_producer("live", seed=3, num_windows=3, period_s=25.0, jitter_s=5.0))
    svc.start()
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
    deadline = time.time() + 30.0
    while len(svc.results) < 3 and time.time() < deadline:
        time.sleep(0.01)
    svc.stop()
    assert svc._thread is None

    results = svc.drain()
    assert [r.window for r in results] == [0, 1, 2]
    ref, _ = _solo_outputs(_all_events(_producer("live", seed=3, num_windows=3)))
    for r in results:
        _assert_output_close(r.output, ref[r.window], 1e-6, f"window {r.window}")


def test_lane_map_and_window_manager_bookkeeping():
    lanes = LaneMap(2)
    assert lanes.admit("a") == 0 and lanes.admit("b") == 1
    with pytest.raises(ValueError):
        lanes.admit("c")                     # full
    with pytest.raises(ValueError):
        lanes.admit("a")                     # duplicate
    assert lanes.evict("a") == 0
    assert lanes.admit("c") == 0             # lowest free lane reused

    wm = WindowManager()
    ev = _all_events(_producer("a", seed=0, num_windows=3))
    assert not wm.add(ev[1], next_window=2)          # stale: dropped
    assert wm.add(ev[2], next_window=2)
    assert wm.pop_ready("a", 1) is None              # gap: not ready
    assert wm.pop_ready("a", 2).window == 2
    assert wm.empty


def test_result_cache_lru_and_counters():
    cache = ResultCache(capacity=2)
    cache.put(("k1",), b"1")
    cache.put(("k2",), b"2")
    assert cache.get(("k1",)) == b"1"     # refreshes k1
    cache.put(("k3",), b"3")              # evicts k2 (LRU)
    assert cache.get(("k2",)) is None
    assert cache.get(("k3",)) == b"3"
    assert cache.hits == 2 and cache.misses == 1
    assert cache.hit_rate == pytest.approx(2 / 3)
    with pytest.raises(ValueError):
        ResultCache(capacity=0)


def test_telemetry_store_codec_roundtrip_is_bitwise(tmp_path):
    store = TelemetryStore(bins_per_window=4)
    rng = np.random.default_rng(0)
    for w in range(3):
        store.ingest(TelemetryWindow(
            window=w, t0_bin=w * 4,
            u_th=rng.random((4, 2)).astype(np.float32),
            power_w=rng.random(4).astype(np.float64) * 400.0,
            extras={"carbon_intensity": rng.random(4).astype(np.float32),
                    "price": rng.random(4).astype(np.float64)}))
    path = tmp_path / "telemetry.bin"
    store.flush(str(path))
    loaded = TelemetryStore.load(str(path))

    assert loaded.bins_per_window == 4
    assert sorted(loaded.windows()) == [0, 1, 2]
    for w in range(3):
        a, b = store.get(w), loaded.get(w)
        assert b.t0_bin == a.t0_bin
        for x, y in [(a.u_th, b.u_th), (a.power_w, b.power_w),
                     *[(a.extras[k], b.extras[k]) for k in a.extras]]:
            assert x.dtype == y.dtype
            assert np.array_equal(x, y)
