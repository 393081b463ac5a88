"""The port's DES against the JAX DES and the plain-Python reference scheduler.

Schedules (``job_start``, ``job_host``) and the per-bin counts
(``queue_len``, ``running``) must be exactly equal; the utilization field
is held at rtol 1e-6.  Inputs are made from a seed with numpy and handed
to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from reference import _rand_score, reference_schedule  # noqa: E402
from repro.core import desim as jdesim  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro.traces.schema import Workload as JWorkload  # noqa: E402
from repro.traces.thermal import PUEParams as JPUEParams  # noqa: E402
from repro.traces.thermal import dynamic_pue as jdynamic_pue  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import desim  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402
from repro_torch.traces.thermal import PUEParams, dynamic_pue  # noqa: E402


def _trace(seed, j, sub_hi, dur_hi, cor_hi, phases=3):
    rng = np.random.default_rng(seed)
    return JWorkload(
        jnp.asarray(np.sort(rng.integers(0, sub_hi, j)).astype(np.int32)),
        jnp.asarray(rng.integers(1, dur_hi, j).astype(np.int32)),
        jnp.asarray(rng.integers(1, cor_hi, j).astype(np.int32)),
        jnp.asarray(rng.uniform(0.2, 1.0, (j, phases)).astype(np.float32)),
        jnp.ones((j,), bool))


#: (trace, num_hosts, cores_per_host, t_bins): the contended cases of
#: tests/test_policies.py, where the policies diverge and backfill fires
_CASES = [
    (_trace(7, 24, 20, 6, 9), 4, 8, 32),
    (_trace(13, 40, 12, 8, 13), 2, 12, 48),
    (_trace(29, 32, 10, 5, 7), 3, 8, 40),
]

_INT_FIELDS = ("job_start", "job_host", "queue_len", "running")


def _assert_same(port, jax_out):
    for k in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(jax_out, k)), err_msg=k)
    np.testing.assert_allclose(port.u_th.numpy(), np.asarray(jax_out.u_th),
                               rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("policy", sorted(desim.PLACEMENT_POLICIES))
@pytest.mark.parametrize("depth", [0, 2])
def test_schedule_matches_jax_and_reference(policy, depth):
    for jw, nh, cph, tb in _CASES:
        kw = dict(num_hosts=nh, cores_per_host=cph, t_bins=tb, policy=policy,
                  backfill_depth=depth)
        port = desim.simulate_utilization(
            convert.workload_from_numpy(jw, device="cpu"), **kw)
        _assert_same(port, jdesim.simulate_utilization(jw, **kw))
        ref_s, ref_h = reference_schedule(
            np.asarray(jw.submit_bin).tolist(), np.asarray(jw.duration_bins).tolist(),
            np.asarray(jw.cores).tolist(), np.asarray(jw.valid).tolist(),
            num_hosts=nh, cores_per_host=cph, t_bins=tb, policy=policy,
            backfill_depth=depth)
        assert port.job_start.tolist() == ref_s, (policy, depth)
        assert port.job_host.tolist() == ref_h, (policy, depth)


@pytest.mark.parametrize("policy", ["worst_fit", "random_fit"])
@pytest.mark.parametrize("depth", [0, 3])
def test_outage_and_drain_match_jax_and_reference(policy, depth):
    """Host 0 has a hard outage (running jobs killed), host 2 drains."""
    jw, nh, cph, tb = _trace(41, 36, 14, 9, 7), 4, 8, 40
    never = np.iinfo(np.int32).max
    fs = np.array([6, never, 10, never], np.int32)
    fe = np.array([18, 0, 22, 0], np.int32)
    fk = np.array([True, False, False, False])
    pid = desim.resolve_policy(policy)
    kw = dict(max_hosts=nh, t_bins=tb, policy_id=pid, backfill_depth=depth,
              max_backfill=depth)
    port = desim.simulate_utilization_masked(
        convert.workload_from_numpy(jw, device="cpu"), torch.ones(nh, dtype=torch.bool),
        cph, fail_start=torch.from_numpy(fs), fail_end=torch.from_numpy(fe),
        fail_kill=torch.from_numpy(fk), **kw)
    want = jdesim.simulate_utilization_masked(
        jw, jnp.ones((nh,), bool), cph, fail_start=jnp.asarray(fs),
        fail_end=jnp.asarray(fe), fail_kill=jnp.asarray(fk), **kw)
    _assert_same(port, want)
    ref_s, ref_h = reference_schedule(
        np.asarray(jw.submit_bin).tolist(), np.asarray(jw.duration_bins).tolist(),
        np.asarray(jw.cores).tolist(), np.asarray(jw.valid).tolist(),
        num_hosts=nh, cores_per_host=cph, t_bins=tb, policy=policy,
        backfill_depth=depth, fail_start=fs.tolist(), fail_end=fe.tolist(),
        fail_kill=fk.tolist())
    assert port.job_start.tolist() == ref_s
    assert port.job_host.tolist() == ref_h


def test_masked_hosts_and_chunked_readout_match_jax():
    """Inactive hosts run nothing; the blocked read-out (bins in chunks of
    a day) equals the one-pass read-out and the JAX engine."""
    jw, nh, cph, tb = _trace(5, 60, 300, 40, 9), 6, 8, 320
    mask = np.array([True, True, False, True, False, True])
    kw = dict(max_hosts=nh, t_bins=tb, policy_id=desim.BEST_FIT)
    w = convert.workload_from_numpy(jw, device="cpu")
    one = desim.simulate_utilization_masked(w, torch.from_numpy(mask), cph, **kw)
    chunked = desim.simulate_utilization_masked(
        w, torch.from_numpy(mask), cph, force_chunked_readout=True, **kw)
    want = jdesim.simulate_utilization_masked(
        jw, jnp.asarray(mask), cph, force_chunked_readout=True, **kw)
    for k in _INT_FIELDS + ("u_th",):
        assert torch.equal(getattr(one, k), getattr(chunked, k)), k
    _assert_same(chunked, want)
    assert float(one.u_th[:, ~torch.from_numpy(mask)].abs().sum()) == 0.0


def test_hash_scores_match_uint32_reference():
    """int64 emulation of the uint32 mix equals the Python replica."""
    hosts = torch.arange(0, 4096, 37, dtype=torch.int64)
    for t, salt in [(0, 0), (5, 3), (2015, 63), (123456, 17)]:
        got = ref.hash_scores(hosts, t, salt).tolist()
        assert got == [_rand_score(h, t, salt) for h in hosts.tolist()]


def test_policy_ids_and_names():
    assert desim.resolve_policy(None) == desim.WORST_FIT
    assert desim.resolve_policy("first_fit") == desim.FIRST_FIT
    with pytest.raises(ValueError, match="unknown placement policy"):
        desim.resolve_policy("fastest_fit")
    with pytest.raises(ValueError, match="max_backfill"):
        desim.simulate_utilization_masked(
            convert.workload_from_numpy(_CASES[0][0], device="cpu"),
            torch.ones(4, dtype=torch.bool), 8, max_hosts=4, t_bins=8,
            max_backfill=32)


def test_predict_metrics_matches_jax_readout():
    """predict_metrics (always the fused readout) vs the JAX Pallas path."""
    rng = np.random.default_rng(5)
    u = rng.uniform(0.0, 1.1, (36, 7)).astype(np.float32)
    ci = rng.uniform(100, 500, 36).astype(np.float32)
    amb = rng.uniform(0, 35, 36).astype(np.float32)
    pr = rng.uniform(0.01, 0.4, 36).astype(np.float32)
    want = jdesim.predict_metrics(
        u, JPowerParams(70.0, 350.0, 2.0),
        JDatacenterConfig(num_hosts=7, cores_per_host=8),
        carbon_intensity=ci, ambient_c=amb, price=pr,
        pue=JPUEParams(base=1.2, amb_coeff=0.03, load_coeff=0.1),
        backend="pallas_interpret")
    got = desim.predict_metrics(
        torch.from_numpy(u),
        convert.power_params_from_numpy(JPowerParams(70.0, 350.0, 2.0), device="cpu"),
        DatacenterConfig(num_hosts=7, cores_per_host=8),
        carbon_intensity=torch.from_numpy(ci), ambient_c=torch.from_numpy(amb),
        price=torch.from_numpy(pr),
        pue=PUEParams(base=1.2, amb_coeff=0.03, load_coeff=0.1))
    for name in ("power_w", "energy_kwh", "tflops", "utilization",
                 "efficiency", "gco2", "pue", "energy_cost"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)
    bare = desim.predict_metrics(torch.from_numpy(u), PowerParams(),
                                 DatacenterConfig(num_hosts=7))
    assert bare.gco2 is None and bare.pue is None and bare.energy_cost is None
    assert bare.power_demand_w is None


@pytest.mark.parametrize("with_ambient", [False, True])
def test_dynamic_pue_matches_jax(with_ambient):
    rng = np.random.default_rng(6 + with_ambient)
    load = rng.uniform(-0.1, 1.1, 40).astype(np.float32)
    amb = rng.uniform(-5.0, 38.0, 40).astype(np.float32) if with_ambient else None
    kw = dict(base=1.15, amb_coeff=0.025, amb_ref=20.0, load_coeff=0.2)
    want = jdynamic_pue(jnp.asarray(load), None if amb is None else jnp.asarray(amb),
                        JPUEParams(**kw))
    got = dynamic_pue(torch.from_numpy(load),
                      None if amb is None else torch.from_numpy(amb), PUEParams(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert torch.equal(dynamic_pue(torch.from_numpy(load), None, PUEParams()),
                       torch.ones(40))
    with pytest.raises(ValueError, match="PUE base"):
        PUEParams(base=0.9)
