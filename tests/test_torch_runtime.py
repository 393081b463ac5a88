"""The port's runtime and trace helpers against the JAX package's.

``failure_arrays``/``HostFailure``, the straggler bridge, the schema
helpers (``stack_workloads``, ``pad_workload``, ``host_mask``) and the
trace loaders and diurnal generators: every array exactly equal to JAX's
on the same inputs, every rejection raised by both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (imports the JAX package in its own order)
from repro.core.feedback import Proposal as JProposal  # noqa: E402
from repro.core.feedback import ProposalKind as JKind  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro.traces import carbon as jcarbon  # noqa: E402
from repro.traces import price as jprice  # noqa: E402
from repro.traces import schema as jschema  # noqa: E402
from repro.traces import thermal as jthermal  # noqa: E402
from repro_torch.core.feedback import Proposal, ProposalKind  # noqa: E402
from repro_torch.runtime import fault, straggler  # noqa: E402
from repro_torch.traces import carbon, price, schema, thermal  # noqa: E402

FAILURE_SETS = [
    (),
    ((0, 3, 9, "outage"),),
    ((2, 0, 5, "degraded"), (5, 10, 40, "outage"), (1, 7, 8, "outage")),
    ((0, 0, 1, "degraded"), (7, 2, 90, "degraded")),
]


@pytest.mark.parametrize("windows", FAILURE_SETS)
def test_failure_arrays_match_jax(windows):
    got = fault.failure_arrays([fault.HostFailure(*w) for w in windows], 8)
    want = jfault.failure_arrays([jfault.HostFailure(*w) for w in windows], 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert fault.NEVER_BIN == jfault.NEVER_BIN


#: (label, args): host failures that both packages reject
BAD_FAILURES = [
    ("empty window", (0, 7, 7)), ("reversed window", (0, 9, 3)),
    ("negative start", (0, -1, 4)), ("negative host", (-1, 0, 5)),
    ("unknown kind", (0, 0, 5, "meltdown")),
]


@pytest.mark.parametrize("label,args", BAD_FAILURES, ids=[b[0] for b in BAD_FAILURES])
def test_host_failure_rejects_as_jax(label, args):
    with pytest.raises(ValueError) as want:
        jfault.HostFailure(*args)
    with pytest.raises(ValueError) as got:
        fault.HostFailure(*args)
    assert str(got.value) == str(want.value)


def test_failure_arrays_rejects_as_jax():
    for windows, n in [(((9, 0, 3, "outage"),), 8),
                       (((0, 0, 3, "outage"), (0, 4, 6, "degraded")), 8)]:
        with pytest.raises(ValueError) as want:
            jfault.failure_arrays([jfault.HostFailure(*w) for w in windows], n)
        with pytest.raises(ValueError) as got:
            fault.failure_arrays([fault.HostFailure(*w) for w in windows], n)
        assert str(got.value) == str(want.value)


def test_degradation_from_stragglers_matches_jax():
    spec = [("restart_straggler", {"host": 2, "ratio": 1.9}), ("recalibrate", {}),
            ("restart_straggler", {"host": 2, "ratio": 2.1}),
            ("restart_straggler", {"host": 0, "ratio": 1.5})]
    got = straggler.degradation_from_stragglers(
        [Proposal(ProposalKind(k), 3, "", impact=i) for k, i in spec],
        start_bin=12, duration_bins=6)
    want = jstraggler.degradation_from_stragglers(
        [JProposal(JKind(k), 3, "", impact=i) for k, i in spec],
        start_bin=12, duration_bins=6)
    assert [(f.host, f.start_bin, f.end_bin, f.kind) for f in got] == \
        [(f.host, f.start_bin, f.end_bin, f.kind) for f in want]


def test_straggler_detector_matches_jax():
    rng = np.random.default_rng(4)
    port, ref = straggler.StragglerDetector(6), jstraggler.StragglerDetector(6)
    for window in range(20):
        times = rng.uniform(0.9, 1.1, 6)
        if window >= 9:
            times[3] *= 1.8
        got, want = port.observe(times, window), ref.observe(times, window)
        assert [(p.kind.value, p.impact) for p in got] == \
            [(p.kind.value, p.impact) for p in want]
    assert port.expected == ref.expected


def _jax_workload(j, seed, defer=True):
    rng = np.random.default_rng(seed)
    return jschema.Workload(
        jnp.asarray(np.sort(rng.integers(0, 30, j)).astype(np.int32)),
        jnp.asarray(rng.integers(1, 9, j).astype(np.int32)),
        jnp.asarray(rng.integers(1, 5, j).astype(np.int32)),
        jnp.asarray(rng.uniform(0, 1, (j, 2)).astype(np.float32)),
        jnp.asarray(rng.uniform(size=j) < 0.9),
        deferrable=jnp.asarray(rng.uniform(size=j) < 0.5) if defer else None)


def _port(jw):
    return schema.Workload(*(None if x is None else torch.as_tensor(np.array(x))
                             for x in (jw.submit_bin, jw.duration_bins, jw.cores,
                                       jw.util_levels, jw.valid, jw.deferrable)))


def _same(got, want):
    for k in ("submit_bin", "duration_bins", "cores", "util_levels", "valid", "deferrable"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("defer", [True, False])
def test_schema_helpers_match_jax(defer):
    jws = [_jax_workload(j, j, defer) for j in (5, 9, 7)]
    _same(schema.stack_workloads([_port(w) for w in jws]), jschema.stack_workloads(jws))
    _same(schema.pad_workload(_port(jws[0]), 12), jschema.pad_workload(jws[0], 12))
    _same(schema.pad_workload(_port(jws[1]), 4), jschema.pad_workload(jws[1], 4))
    for n, m in [(3, 5), ([1, 5, 0], 5), (np.array([2, 2]), 4)]:
        np.testing.assert_array_equal(schema.host_mask(n, m).numpy(),
                                      np.asarray(jschema.host_mask(n, m)))
    np.testing.assert_array_equal(_port(jws[2]).cpu_hours().numpy(),
                                  np.asarray(jws[2].cpu_hours()))
    with pytest.raises(ValueError, match="at least one"):
        schema.stack_workloads([])


@pytest.mark.parametrize("t_bins,seed", [(288, 0), (700, 3), (2016, None), (5, 7)])
def test_diurnal_generators_match_jax(t_bins, seed):
    for port_fn, jax_fn in ((price.make_diurnal_price, jprice.make_diurnal_price),
                            (thermal.make_diurnal_ambient, jthermal.make_diurnal_ambient),
                            (carbon.make_diurnal_carbon, jcarbon.make_diurnal_carbon)):
        got, want = port_fn(t_bins, seed=seed), jax_fn(t_bins, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_trace_loaders_match_jax(tmp_path):
    """One-column and ``timestamp,value`` files, a comment and a header
    row, tiled and truncated to the horizon; bad rows and values rejected
    by both."""
    rows = {"carbon": [310.5, 220.0, 180.25, 400.0],
            "price": [0.12, -0.03, 0.3, 0.08, 0.2],
            "ambient": [14.0, 18.5, 22.0]}
    pairs = {"carbon": (carbon.load_carbon_intensity, jcarbon.load_carbon_intensity),
             "price": (price.load_price_trace, jprice.load_price_trace),
             "ambient": (thermal.load_ambient, jthermal.load_ambient)}
    for name, vals in rows.items():
        plain = tmp_path / f"{name}.csv"
        plain.write_text("\n".join(str(v) for v in vals) + "\n")
        stamped = tmp_path / f"{name}_ts.csv"
        stamped.write_text("# exported\ntime,value\n"
                           + "\n".join(f"2024-01-01T00:{i:02d},{v}" for i, v in enumerate(vals)))
        port_fn, jax_fn = pairs[name]
        for path in (plain, stamped):
            for t_bins in (None, 2, 11):
                got, want = port_fn(str(path), t_bins), jax_fn(str(path), t_bins)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        bad = tmp_path / f"{name}_bad.csv"
        bad.write_text(f"{vals[0]}\nn/a\n")
        for fn in (port_fn, jax_fn):
            with pytest.raises(ValueError, match="non-numeric row"):
                fn(str(bad))
        nan = tmp_path / f"{name}_nan.csv"
        nan.write_text("1.0\nnan\n")
        for fn in (port_fn, jax_fn):
            with pytest.raises(ValueError, match="non-finite"):
                fn(str(nan))
