"""The port's lane-axis DES (the scenario axis S) against the plain-Python
reference scheduler, the JAX package's DES vmapped over scenarios, and the
port's own unbatched runs.

Every lane of ``simulate_utilization_masked`` on ``[S, J]`` workload
leaves goes through one ``ops.des_place`` call (its plain version on the
CPU).  Schedules (``job_start``, ``job_host``) and counts (``queue_len``,
``running``) must be exactly equal to JAX's; the utilization field is held
at rtol 1e-6 against JAX and bit for bit against the port's own unbatched
run.  Inputs are made from a seed with numpy and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from reference import reference_schedule  # noqa: E402
from repro.core import desim as jdesim  # noqa: E402
from repro.core.power import PowerParams as JPowerParams  # noqa: E402
from repro.traces.schema import DatacenterConfig as JDatacenterConfig  # noqa: E402
from repro.traces.schema import Workload as JWorkload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import desim  # noqa: E402
from repro_torch.core.power import PowerParams  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig, Workload  # noqa: E402

NEVER = int(np.iinfo(np.int32).max)
INT_FIELDS = ("job_start", "job_host", "queue_len", "running")

#: lanes, jobs, padded hosts, bins, backfill window
S, J, H, T, MB = 16, 48, 6, 48, 3


def lane_batch(seed):
    """S lanes of one contended trace each, every policy x backfill depth
    {0, MB} x {no failure, outage + drain}, host counts 3..H, cores 6..9."""
    rng = np.random.default_rng(seed)
    sub = np.sort(rng.integers(0, T // 2, (S, J)), axis=1).astype(np.int32)
    w = dict(submit_bin=sub, duration_bins=rng.integers(0, 9, (S, J)).astype(np.int32),
             cores=rng.integers(1, 8, (S, J)).astype(np.int32),
             util_levels=rng.uniform(0.1, 1.0, (S, J, 3)).astype(np.float32),
             valid=rng.uniform(size=(S, J)) < 0.95)
    lane = np.arange(S)
    hosts = rng.integers(3, H + 1, S)
    fs = np.full((S, H), NEVER, np.int32)
    fe = np.zeros((S, H), np.int32)
    fk = np.zeros((S, H), bool)
    failing = (lane // 8) % 2 == 1
    fs[failing, 0], fe[failing, 0], fk[failing, 0] = 8, 20, True       # outage
    fs[failing, 1], fe[failing, 1] = 4, 30                             # drain
    return w, dict(
        host_mask=np.arange(H)[None, :] < hosts[:, None],
        cores_per_host=rng.integers(6, 10, S).astype(np.int32),
        policy_id=(lane % 4).astype(np.int32),
        backfill_depth=np.where((lane // 4) % 2 == 1, MB, 0).astype(np.int32),
        fail_start=fs, fail_end=fe, fail_kill=fk)


def port_run(w, lanes, **kw):
    wl = Workload(**{k: torch.as_tensor(v) for k, v in w.items()})
    return desim.simulate_utilization_masked(
        wl, torch.as_tensor(lanes["host_mask"]), torch.as_tensor(lanes["cores_per_host"]),
        max_hosts=H, t_bins=T, policy_id=torch.as_tensor(lanes["policy_id"]),
        backfill_depth=torch.as_tensor(lanes["backfill_depth"]), max_backfill=MB,
        **{k: torch.as_tensor(lanes[k]) for k in ("fail_start", "fail_end", "fail_kill")},
        **kw)


@pytest.fixture(scope="module")
def batch():
    w, lanes = lane_batch(3)
    return w, lanes, port_run(w, lanes)


def test_each_lane_matches_reference_schedule(batch):
    """Every policy x backfill x failure setting, lane by lane, against
    the event-semantics reference scheduler (exact)."""
    w, lanes, got = batch
    for s in range(S):
        n = int(lanes["host_mask"][s].sum())
        failing = bool((lanes["fail_start"][s] < NEVER).any())
        ref_s, ref_h = reference_schedule(
            w["submit_bin"][s].tolist(), w["duration_bins"][s].tolist(),
            w["cores"][s].tolist(), w["valid"][s].tolist(), num_hosts=n,
            cores_per_host=int(lanes["cores_per_host"][s]), t_bins=T,
            policy=desim.POLICY_NAMES[int(lanes["policy_id"][s])],
            backfill_depth=int(lanes["backfill_depth"][s]),
            **(dict(fail_start=lanes["fail_start"][s, :n].tolist(),
                    fail_end=lanes["fail_end"][s, :n].tolist(),
                    fail_kill=lanes["fail_kill"][s, :n].tolist()) if failing else {}))
        assert got.job_start[s].tolist() == ref_s, s
        assert got.job_host[s].tolist() == ref_h, s


def test_lanes_match_vmapped_jax(batch):
    """The batch against ``jax.vmap`` of the JAX DES over the lanes: counts
    exact, ``u_th`` within rtol 1e-6."""
    w, lanes, got = batch

    def one(wl, mask, cph, pid, depth, fs, fe, fk):
        return jdesim.simulate_utilization_masked(
            wl, mask, cph, max_hosts=H, t_bins=T, policy_id=pid,
            backfill_depth=depth, max_backfill=MB, fail_start=fs, fail_end=fe,
            fail_kill=fk)

    jw = JWorkload(*(jnp.asarray(w[k]) for k in ("submit_bin", "duration_bins", "cores",
                                                 "util_levels", "valid")))
    want = jax.vmap(one)(jw, *(jnp.asarray(lanes[k]) for k in (
        "host_mask", "cores_per_host", "policy_id", "backfill_depth", "fail_start",
        "fail_end", "fail_kill")))
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.u_th.numpy(), np.asarray(want.u_th), rtol=1e-6, atol=0.0)


def test_each_lane_equals_its_unbatched_run(batch):
    """Lane s of the batch equals the unbatched call with lane s's
    settings, bit for bit (every leaf); a lane without failures in a batch
    that has them equals its run with no failure arrays at all."""
    w, lanes, got = batch
    for s in range(S):
        wl = Workload(**{k: torch.as_tensor(v[s]) for k, v in w.items()})
        failing = bool((lanes["fail_start"][s] < NEVER).any())
        fail = ({k: torch.as_tensor(lanes[k][s]) for k in ("fail_start", "fail_end", "fail_kill")}
                if failing else {})
        solo = desim.simulate_utilization_masked(
            wl, torch.as_tensor(lanes["host_mask"][s]), int(lanes["cores_per_host"][s]),
            max_hosts=H, t_bins=T, policy_id=int(lanes["policy_id"][s]),
            backfill_depth=int(lanes["backfill_depth"][s]), max_backfill=MB, **fail)
        for k in INT_FIELDS + ("u_th",):
            assert torch.equal(getattr(got, k)[s], getattr(solo, k)), (s, k)


def test_lane_zero_at_one_lane_equals_the_solo_run():
    w, lanes = lane_batch(11)
    one = {k: v[:1] for k, v in w.items()}
    first = {k: v[:1] for k, v in lanes.items()}
    got = port_run(one, first)
    solo = desim.simulate_utilization_masked(
        Workload(**{k: torch.as_tensor(v[0]) for k, v in w.items()}),
        torch.as_tensor(lanes["host_mask"][0]), int(lanes["cores_per_host"][0]),
        max_hosts=H, t_bins=T, policy_id=int(lanes["policy_id"][0]),
        backfill_depth=int(lanes["backfill_depth"][0]), max_backfill=MB,
        **{k: torch.as_tensor(lanes[k][0]) for k in ("fail_start", "fail_end", "fail_kill")})
    for k in INT_FIELDS + ("u_th",):
        assert getattr(got, k).shape[0] == 1
        assert torch.equal(getattr(got, k)[0], getattr(solo, k)), k


def test_chunked_lane_readout_equals_one_pass(batch):
    """The read-out over time blocks (as the batch threshold chunks it)
    changes no bit."""
    w, lanes, got = batch
    chunked = port_run(w, lanes, force_chunked_readout=True)
    for k in INT_FIELDS + ("u_th",):
        assert torch.equal(getattr(got, k), getattr(chunked, k)), k


def test_des_place_counts_attempts_and_checks_operands(batch):
    """``ops.des_place`` on the CPU: attempts equal placements plus blocked
    bins, never fewer than the placements; bad operands raise."""
    w, lanes, got = batch
    args = [torch.as_tensor(x) for x in (
        w["submit_bin"], w["duration_bins"], w["cores"], w["valid"], lanes["host_mask"],
        lanes["cores_per_host"], lanes["policy_id"], lanes["backfill_depth"])]
    fails = {k: torch.as_tensor(lanes[k]) for k in ("fail_start", "fail_end", "fail_kill")}
    start, host, attempts = ops.des_place(*args, t_bins=T, max_backfill=MB, **fails)
    assert torch.equal(start, got.job_start) and torch.equal(host, got.job_host)
    placed = (start >= 0).sum(dim=1)
    assert bool((attempts >= placed).all()) and bool((attempts <= placed + T).all())
    with pytest.raises(ValueError, match="max_backfill"):
        ops.des_place(*args, t_bins=T, max_backfill=32)
    with pytest.raises(ValueError, match="together"):
        ops.des_place(*args, t_bins=T, max_backfill=MB, fail_start=fails["fail_start"])
    with pytest.raises(ValueError, match="cores_per_host"):
        ops.des_place(*args[:5], args[5][:3], *args[6:], t_bins=T, max_backfill=MB)


def test_max_starts_per_bin_caps_a_bin():
    """A bin where more jobs fit than ``max_starts_per_bin`` places that
    many and carries the rest over, as the JAX DES does."""
    j = 12
    jw = JWorkload(jnp.zeros(j, jnp.int32), jnp.full(j, 3, jnp.int32),
                   jnp.ones(j, jnp.int32), jnp.full((j, 1), 0.5, jnp.float32),
                   jnp.ones(j, bool))
    kw = dict(num_hosts=2, cores_per_host=8, t_bins=6, max_starts_per_bin=5)
    want = jdesim.simulate_utilization(jw, **kw)
    got = desim.simulate_utilization(convert.workload_from_numpy(jw, device="cpu"), **kw)
    assert got.job_start.tolist() == np.asarray(want.job_start).tolist()
    assert got.job_start.tolist().count(0) == 5
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_simulate_matches_jax():
    """``desim.simulate`` (FR2's one call) against JAX's: schedule exact,
    prediction within rtol 1e-5 (the readout's bar)."""
    rng = np.random.default_rng(9)
    j, t = 60, 72
    jw = JWorkload(jnp.asarray(np.sort(rng.integers(0, 40, j)).astype(np.int32)),
                   jnp.asarray(rng.integers(1, 12, j).astype(np.int32)),
                   jnp.asarray(rng.integers(1, 9, j).astype(np.int32)),
                   jnp.asarray(rng.uniform(0.1, 1.0, (j, 3)).astype(np.float32)),
                   jnp.ones(j, bool))
    jdc = JDatacenterConfig(num_hosts=5, cores_per_host=8)
    want_sim, want = jdesim.simulate(jw, jdc, t, JPowerParams(65.0, 320.0, 2.2))
    got_sim, got = desim.simulate(convert.workload_from_numpy(jw, device="cpu"),
                                  DatacenterConfig(num_hosts=5, cores_per_host=8), t,
                                  PowerParams(65.0, 320.0, 2.2))
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got_sim, k).numpy(),
                                      np.asarray(getattr(want_sim, k)), err_msg=k)
    for k in ("power_w", "energy_kwh", "tflops", "utilization", "efficiency"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, err_msg=k)
