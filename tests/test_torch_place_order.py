"""The card's ``des_place`` decision and bookkeeping, against the plain
version and the JAX package's DES.

The kernel (``csrc/des_place.cu``) decides in one warp: lane l owns the
host groups g = l, l + 32, ... (hosts 4g..4g+3), keeps its best
``fits ? score : -1`` with the lowest host holding it (trees over
``kRounds`` rounds of groups at a time, a later batch only if strictly
greater), and the warp takes ``__reduce_max_sync`` over the scores, then
``__reduce_min_sync`` over the hosts of the lanes that hold the max.  Job
fields come from a ring of ``kWindow`` jobs in shared memory, refilled
``kChunk`` at a time with ``cp.async`` when the head comes within two
chunks of the window's end; the release row of bin t + 1 is prefetched at
bin t's start, so a placement that ends at t + 1 goes to a late row and
later ends to the global table; backfill candidates are scored only when
the head fits nowhere.  The kernel runs only on a card, so a numpy model
of that decision and that bookkeeping lives here, on no path, with the
source's constants: it asserts that every read of the window hits a slot
that holds its job and whose copy has landed, and that no global write
goes to a row already prefetched.  It is held against the int64-key
argmax of ``ref._policy_host`` and JAX's ``_policy_host``, and its
schedules against ``ref.des_place_ref`` and the JAX DES, exactly.
``chip_smoke.py`` then holds the card kernel against the plain version.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import desim as jdesim  # noqa: E402
from repro.traces.schema import Workload as JWorkload  # noqa: E402
from repro_torch.kernels import des_place, ref  # noqa: E402
from repro_torch.traces.schema import DatacenterConfig  # noqa: E402
from repro_torch.traces.surf import BINS_PER_DAY, SurfTraceSpec, make_surf22_like  # noqa: E402

_SRC = (pathlib.Path(des_place.__file__).parent / "csrc" / "des_place.cu").read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)( \* kChunk)?;", _SRC)
    assert m, f"{name} not found in des_place.cu"
    return int(m.group(1)) * (_const("kChunk") if m.group(2) else 1)


CHUNK, WINDOW, ROUNDS = _const("kChunk"), _const("kWindow"), _const("kRounds")
MAX_BACKFILL, MAX_HOSTS = _const("kMaxBackfill"), _const("kMaxHosts")
INT_MIN, INT_MAX, UINT_MAX = -2**31, 2**31 - 1, 2**32 - 1
NEVER = int(np.iinfo(np.int32).max)
POLICIES = range(4)


def hash_scores(h, t: int, salt: int):
    """The random-fit hash in native uint32, as the kernel computes it."""
    with np.errstate(over="ignore"):
        x = (np.atleast_1d(np.asarray(h, np.uint32)) * np.uint32(0x9E3779B1)
             ^ np.uint32((t * 0x85EBCA77) & UINT_MAX)
             ^ np.uint32((salt * 0xC2B2AE3D) & UINT_MAX))
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return (x & np.uint32(0x7FFFFF)).astype(np.int64)


def scores(free, policy: int, t: int, salt: int, h: int):
    """The policy's score of every (padded) host, int64."""
    idx = np.arange(free.shape[0])
    if policy == ref.FIRST_FIT:
        return h - idx
    if policy == ref.BEST_FIT:
        return ref.BEST_FIT_BIAS - np.minimum(free, ref.BEST_FIT_BIAS - 1)
    if policy == ref.WORST_FIT:
        return free.astype(np.int64)
    return hash_scores(idx, t, salt)


def warp_pick(free, on, need: int, policy: int, t: int, salt: int, h: int):
    """``pick_host``: ``(score, host)`` held by every lane of the warp,
    ``score`` -1 where the job fits nowhere.  ``free``/``on`` are padded to
    a multiple of 4 hosts.  A lane takes its groups ``ROUNDS`` rounds at a
    time (as few as cover the hosts): a batch's largest score and the
    lowest index holding it, replacing the lane's best only if strictly
    greater; then the warp's largest score and the lowest host among the
    lanes holding it."""
    v = np.where(on & (free >= need), scores(free, policy, t, salt, h), -1)
    groups = v.shape[0] // 4
    rounds = -(-groups // 32)
    per_batch = min(rounds, ROUNDS)
    batches = -(-rounds // per_batch)
    vv = np.full((batches * per_batch * 32, 4), INT_MIN, np.int64)
    vv[:groups] = v.reshape(groups, 4)
    vv = vv.reshape(batches, per_batch, 32, 4).transpose(0, 2, 1, 3)  # [batch, lane, round, i]
    vv = vv.reshape(batches, 32, per_batch * 4)
    best = np.full(32, INT_MIN, np.int64)
    best_host = np.full(32, INT_MAX, np.int64)
    lanes = np.arange(32)
    for b in range(batches):
        top = vv[b].max(axis=1)                                  # tree_max
        first = np.where(vv[b] == top[:, None], np.arange(per_batch * 4), per_batch * 4).min(axis=1)
        host = 4 * (b * per_batch * 32 + lanes + 32 * (first >> 2)) + (first & 3)
        take = top > best
        best = np.where(take, top, best)
        best_host = np.where(take, host, best_host)
    m = int(best.max())                                          # __reduce_max_sync
    return m, int(np.where(best == m, best_host, UINT_MAX).min())  # __reduce_min_sync


def _pad(x, hp, fill):
    out = np.full(hp, fill, x.dtype)
    out[:x.shape[0]] = x
    return out


def _key_picks(free, on, need, policy, t, salt):
    """``(any fits, host)`` of the int64-key argmax: the plain version's
    ``_policy_host`` and JAX's."""
    h = free.shape[0]
    idx = torch.arange(h, dtype=torch.int64)
    fits = (torch.as_tensor(free) >= need) & torch.as_tensor(on)
    score = ref._policy_score(torch.as_tensor(free), policy, t, salt, idx)
    got_ref = int(ref._policy_host(score, fits, idx))
    got_jax = int(jdesim._policy_host(jnp.asarray(free, jnp.int32), jnp.asarray(fits.numpy()),
                                      jnp.int32(policy), jnp.int32(t), jnp.int32(salt), h))
    return bool(fits.any()), got_ref, got_jax


def _check_pick(free, on, need, policy, t, salt):
    h = free.shape[0]
    hp = -(-h // 4) * 4
    m, host = warp_pick(_pad(free, hp, 0), _pad(on, hp, False), need, policy, t, salt, h)
    fits, want_ref, want_jax = _key_picks(free, on, need, policy, t, salt)
    assert (m >= 0) == fits
    if fits:
        assert host == want_ref == want_jax, (policy, host, want_ref, want_jax)
    else:
        assert m == -1
    return m, host


@pytest.mark.parametrize("h", [1, 33, 277, MAX_HOSTS])
@pytest.mark.parametrize("policy", POLICIES)
def test_redux_pick_equals_key_argmax(h, policy):
    """The two-stage argmax against the int64 key's, at H = 1, 33, 277 and
    the kernel's largest, with many ties (free cores from a small set) and
    hosts offline."""
    rng = np.random.default_rng(h * 7 + policy)
    for trial in range(6 if h < MAX_HOSTS else 2):
        free = rng.choice([0, 3, 8, 16], size=h).astype(np.int32)
        on = rng.uniform(size=h) < 0.8
        _check_pick(free, on, int(rng.integers(1, 12)), policy, int(rng.integers(0, 2016)),
                    int(rng.integers(0, 64)))


@pytest.mark.parametrize("h", [1, 33, 277, MAX_HOSTS])
@pytest.mark.parametrize("policy", POLICIES)
def test_ties_and_unfit_rows(h, policy):
    """Every host tied: the lowest online one wins; no host fits: score -1
    (the plain version's head does not fit)."""
    free = np.full(h, 16, np.int32)
    on = np.ones(h, bool)
    on[: h // 2] = False
    m, host = _check_pick(free, on, 4, policy, 5, 0)
    if policy != ref.RANDOM_FIT:
        assert host == h // 2
    m, _ = _check_pick(free, on, 17, policy, 5, 0)
    assert m == -1
    m, _ = _check_pick(free, np.zeros(h, bool), 0, policy, 5, 0)
    assert m == -1


def test_extreme_scores_fit_the_32_bit_reduction():
    """Best-fit scores at 2^24 - 1 and 2^24 (free 1 and 0, need 0), free
    beyond 2^24, and a random-fit hash at its largest, 2^23 - 1 (bin 136,
    salt 0, host 3814)."""
    h = 277
    for free in ([1] * h, [0] + [1] * (h - 1), [2**24 - 2, 2**24 - 1, 2**24, 2**30] * 69 + [5]):
        free = np.asarray(free, np.int32)
        for policy in POLICIES:
            _check_pick(free, np.ones(h, bool), 0, policy, 3, 1)
    assert int(hash_scores(3814, 136, 0)[0]) == 2**23 - 1
    assert int(ref.hash_scores(torch.tensor([3814]), 136, 0)) == 2**23 - 1
    m, host = _check_pick(np.full(MAX_HOSTS, 4, np.int32), np.ones(MAX_HOSTS, bool), 1,
                          ref.RANDOM_FIT, 136, 0)
    assert (m, host) == (2**23 - 1, 3814)


def test_source_constants_keep_the_window_ahead_of_the_head():
    """An attempt reads jobs head .. head + kMaxBackfill and a placement
    moves the head by at most kMaxBackfill + 1: the refill (when the head
    passes hi - 2 kChunk) lands at least kChunk - kMaxBackfill - 2 jobs
    ahead of any read and overwrites only jobs behind the head."""
    assert WINDOW >= 3 * CHUNK and WINDOW & (WINDOW - 1) == 0
    assert CHUNK > 2 * (MAX_BACKFILL + 2)
    assert "fill(hi);" in _SRC and "head > hi - 2 * kChunk" in _SRC


class Window:
    """The ring of job fields in shared memory, slot by slot, with the job
    each slot holds and the chunk still in flight."""

    def __init__(self, jobs, chunk, window):
        self.jobs, self.chunk, self.window = jobs, chunk, window
        self.fields = np.zeros((window, 4), np.int64)
        self.tag = np.full(window, -1)
        self.pending = range(0)
        self.refills = 0
        for lo in range(0, window, chunk):
            self.fill(lo, head=0)
        self.pending = range(0)                   # cp.async.wait_group 0
        self.hi = window

    def fill(self, lo, head):
        for j in range(lo, lo + self.chunk):
            slot = j % self.window
            assert self.tag[slot] < head, "a refill overwrote a job at or past the head"
            self.tag[slot] = j
            self.fields[slot] = (self.jobs[j] if j < self.jobs.shape[0]
                                 else (NEVER, 0, 0, 0))
        self.pending = range(lo, lo + self.chunk)

    def refill_if_low(self, head):
        if head > self.hi - 2 * self.chunk:
            self.fill(self.hi, head)               # newest chunk in flight
            self.hi += self.chunk
            self.refills += 1
            return True
        return False

    def __getitem__(self, j):
        slot = j % self.window
        assert self.tag[slot] == j, f"job {j}: its slot holds job {self.tag[slot]}"
        assert j not in self.pending, f"job {j} read before its copy landed"
        return self.fields[slot]


def kernel_model(o, lane: int, *, t_bins: int, max_starts: int, max_backfill: int,
                 chunk: int = CHUNK, window: int = WINDOW):
    """One lane of ``des_place_kernel`` on :func:`des_place.operands`' dict
    ``o`` (CPU tensors): ``(job_start, job_host, attempts, counts)``,
    ``counts`` the mechanisms it went through."""
    jobs = o["jobs"][lane].numpy().astype(np.int64)
    j_count, h = jobs.shape[0], o["mask"].shape[1]
    t_count = t_bins
    hp = o["release"].shape[2]
    assert hp == -(-h // 4) * 4 and o["release"].shape[1] == t_bins
    mask = _pad(o["mask"][lane].numpy().astype(bool), hp, False)
    cph = int(o["cores_per_host"][lane])
    policy = min(max(int(o["policy"][lane]), 0), 3)
    depth = max(min(int(o["depth"][lane]), max_backfill), 0)
    fail = "fail_start" in o
    free = np.where(mask, cph, 0).astype(np.int64)
    on = mask.copy()
    if fail:
        fs = np.where(mask, _pad(o["fail_start"][lane].numpy().astype(np.int64), hp, 0), INT_MIN)
        fe = np.where(mask, _pad(o["fail_end"][lane].numpy().astype(np.int64), hp, 0), INT_MAX)
        kill = mask & _pad(o["fail_kill"][lane].numpy().astype(bool), hp, False)
    release = np.zeros((t_count, hp), np.int64)       # the global table
    rel = np.zeros(hp, np.int64)                      # the prefetched row
    late = np.zeros(hp, np.int64)
    win = Window(jobs, chunk, window)
    job_start = np.full(j_count, -1)
    job_host = np.full(j_count, -1)
    head, attempts, skip = 0, 0, 0
    counts = dict(late=0, red=0, dropped=0, candidate_passes=0, backfills=0)
    refilled = False
    for t in range(t_count):
        if not refilled:                              # cp.async.wait_group 0
            win.pending = range(0)
        refilled = False
        free = free + rel + late
        late[:] = 0
        if fail:
            on = ~((fs <= t) & (t < fe))
        prefetched = t + 1
        rel = release[t + 1].copy() if t + 1 < t_count else np.zeros(hp, np.int64)
        placed = 0
        go = max_starts > 0 and win[head][0] <= t
        while go:
            attempts += 1
            salt = placed
            ready, dur, need, _ = win[head]
            m, host = warp_pick(free, on, int(need), policy, t, salt, h)
            jid, d_sel = -1, 0
            if m >= 0:
                jid = head
            elif depth > 0:                           # the candidates' warps
                picks = []
                for d in range(1, depth + 1):
                    c = win[head + d]
                    pick = -1
                    if not (skip >> d) & 1 and c[0] <= t:
                        counts["candidate_passes"] += 1
                        cm, ch = warp_pick(free, on, int(c[2]), policy, t, salt, h)
                        pick = ch if cm >= 0 else -1
                    picks.append(pick)
                ok = [d for d, p in enumerate(picks, 1) if p >= 0]
                if ok:
                    d_sel = ok[0]
                    host, jid = picks[d_sel - 1], head + d_sel
                    _, dur, need, _ = win[jid]
                    counts["backfills"] += 1
            if jid < 0:
                break
            free[host] -= need
            end = t + max(int(dur), 1)
            if fail and kill[host] and t < fs[host] and end > fs[host]:
                end = int(fe[host])
            if end == t + 1 and end < t_count:
                late[host] += need
                counts["late"] += 1
            elif t + 1 < end < t_count:
                assert end > prefetched, "a global write to a prefetched row"
                release[end, host] += need
                counts["red"] += 1
            else:
                counts["dropped"] += 1
            job_start[jid], job_host[jid] = t, host
            placed += 1
            if jid == head:
                rest = skip >> 1
                run = (~rest & -~rest).bit_length() - 1     # trailing ones of rest
                head, skip = head + 1 + run, rest >> run
                refilled |= win.refill_if_low(head)
            else:
                skip |= 1 << d_sel
            go = placed < max_starts and win[head][0] <= t
    counts["refills"] = win.refills
    return job_start, job_host, attempts, counts


def _model_vs_plain(args, kw, *, chunk=CHUNK, window=WINDOW):
    """Every lane of the model against ``ref.des_place_ref``: equal
    schedules and attempts; returns the summed counts and the plain
    version's outputs."""
    t_bins, mb = kw["t_bins"], kw["max_backfill"]
    ms = kw.get("max_starts_per_bin", 64)
    fails = {k: kw[k] for k in ("fail_start", "fail_end", "fail_kill") if k in kw}
    o = des_place.operands(*args, t_bins=t_bins, **fails)
    want = ref.des_place_ref(*args, t_bins=t_bins, max_starts_per_bin=ms, max_backfill=mb,
                             **fails)
    total = {}
    for s in range(args[0].shape[0]):
        js, jh, n, counts = kernel_model(o, s, t_bins=t_bins, max_starts=ms, max_backfill=mb,
                                         chunk=chunk, window=window)
        assert js.tolist() == want[0][s].tolist(), s
        assert jh.tolist() == want[1][s].tolist(), s
        assert n == int(want[2][s]), s
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, want


def random_case(seed, s, j, h, t, mb, fails, long=False):
    """Random placement operands as ``chip_smoke.random_place_case`` makes
    them: a contended trace a lane, durations 0-8, 1-8 cores a job, 5 % of
    the jobs not valid, every policy, depths up to ``mb``, outage/drain
    windows on 40 % of the hosts.  A head that never fits (8 cores on
    hosts of 6) or is not valid stops its lane for good, so with ``long``
    jobs take 1-6 cores and the invalid jobs are a padded tail."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor
    args = (x(np.sort(rng.integers(0, max(t // 2, 1), (s, j)), axis=1).astype(np.int32)),
            x(rng.integers(0, 9, (s, j)).astype(np.int32)),
            x(rng.integers(1, 7 if long else 9, (s, j)).astype(np.int32)),
            x(np.arange(j)[None, :].repeat(s, 0) < 0.95 * j if long
              else rng.uniform(size=(s, j)) < 0.95),
            x(np.arange(h)[None, :] < rng.integers(1, h + 1, (s, 1))),
            x(rng.integers(6, 12, s).astype(np.int32)),
            x((np.arange(s) % 4).astype(np.int32)),
            x(rng.integers(0, mb + 1, s).astype(np.int32)))
    kw = dict(max_backfill=mb, t_bins=t)
    if fails:
        fs = np.where(rng.uniform(size=(s, h)) < 0.4, rng.integers(0, t, (s, h)),
                      NEVER).astype(np.int32)
        fe = np.minimum(fs.astype(np.int64) + rng.integers(1, max(t // 2, 2), (s, h)),
                        NEVER).astype(np.int32)
        kw.update(fail_start=x(fs), fail_end=x(fe), fail_kill=x(rng.uniform(size=(s, h)) < 0.6))
    return args, kw


def _jax_schedules(args, kw):
    """``jax.vmap`` of the JAX DES over the lanes: ``(job_start, job_host)``."""
    submit, dur, cores, valid, mask, cph, pid, depth = (np.asarray(a) for a in args)
    util = np.full(submit.shape + (1,), 0.5, np.float32)

    def one(sb, db, c, v, u, m, cp, p, d, *fail):
        fkw = dict(zip(("fail_start", "fail_end", "fail_kill"), fail))
        out = jdesim.simulate_utilization_masked(
            JWorkload(sb, db, c, u, v), m, cp, max_hosts=mask.shape[1], t_bins=kw["t_bins"],
            max_starts_per_bin=kw.get("max_starts_per_bin", 64), policy_id=p,
            backfill_depth=d, max_backfill=kw["max_backfill"], **fkw)
        return out.job_start, out.job_host

    fails = [np.asarray(kw[k]) for k in ("fail_start", "fail_end", "fail_kill") if k in kw]
    return jax.vmap(one)(submit, dur, cores, valid, util, mask, cph, pid, depth, *fails)


@pytest.mark.parametrize("chunk", [CHUNK, 32])
@pytest.mark.parametrize("case", [(300, 6, 400, 33, 72, 31, True),
                                  (305, 6, 600, 33, 240, 31, True, True)])
def test_model_matches_plain_and_jax_on_random_lanes(case, chunk):
    """Random lanes with ``max_backfill`` 31, outages, drains and kills
    (``chip_smoke.py``'s case, and a longer one where every job fits some
    host), at the source's window and at a window of 32-job chunks, the
    least that keeps 31 candidates inside it (refills): the model's
    schedules and attempts equal the plain version's, and the JAX DES's
    schedules; the late row, the global releases and backfill are used."""
    args, kw = random_case(*case)
    total, want = _model_vs_plain(args, kw, chunk=chunk, window=4 * chunk)
    js, jh = _jax_schedules(args, kw)
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(jh))
    assert total["late"] > 0 and total["red"] > 0 and total["backfills"] > 0
    if chunk == 32 and len(case) > 7:
        assert total["refills"] >= 6 * 8


@pytest.mark.parametrize("case", [(8, 60, 5, 40, 3, True), (8, 120, 9, 64, 0, False),
                                  (1, 30, 1, 24, 0, False)])
def test_model_matches_plain_on_small_lanes(case):
    """Few hosts (one among them), no backfill or a short window, with and
    without failures, at the source's window and at chunks of 32 jobs."""
    args, kw = random_case(17 + case[1], *case)
    for chunk in (CHUNK, 32):
        _model_vs_plain(args, kw, chunk=chunk, window=4 * chunk)


def test_model_matches_plain_and_jax_on_an_e2_like_trace():
    """Two days of the SURF-22 generator at the paper's 277 hosts (1852
    jobs, so the source's window refills), worst fit without backfill as
    the twin runs it and best fit with backfill 4, and a hard bin cap:
    schedules and attempts equal the plain version's and JAX's."""
    dc = DatacenterConfig()
    w = make_surf22_like(SurfTraceSpec(days=2.0, seed=22), dc, device="cpu")
    t_bins = int(2 * BINS_PER_DAY)
    lanes = 2
    rep = lambda x: x[None].expand(lanes, *x.shape).contiguous()  # noqa: E731
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)  # noqa: E731
    args = (rep(w.submit_bin), rep(w.duration_bins), rep(w.cores), rep(w.valid),
            torch.ones((lanes, dc.num_hosts), dtype=torch.bool),
            i32([dc.cores_per_host] * lanes), i32([ref.WORST_FIT, ref.BEST_FIT]), i32([0, 4]))
    for ms in (64, 3):
        kw = dict(t_bins=t_bins, max_backfill=4, max_starts_per_bin=ms)
        total, want = _model_vs_plain(args, kw)
        assert total["refills"] > 0
        js, jh = _jax_schedules(args, kw)
        np.testing.assert_array_equal(want[0].numpy(), np.asarray(js))
        np.testing.assert_array_equal(want[1].numpy(), np.asarray(jh))


def test_operands_pack_the_job_table_and_pad_the_release_rows():
    """``des_place.operands``: the ready bin is the submit bin, or NEVER
    where a job is not valid; the release table has T rows of H rounded
    up to 4 hosts, zero."""
    args, kw = random_case(5, 3, 20, 7, 16, 2, False)
    o = des_place.operands(*args, t_bins=16)
    assert o["jobs"].shape == (3, 20, 4) and o["jobs"].dtype == torch.int32
    want_ready = torch.where(args[3], args[0], NEVER)
    assert torch.equal(o["jobs"][..., 0], want_ready)
    assert torch.equal(o["jobs"][..., 1], args[1]) and torch.equal(o["jobs"][..., 2], args[2])
    assert o["release"].shape == (3, 16, 8) and not bool(o["release"].any())
