"""The frozen count formulas against a count made by running the work they
describe, at small shapes: an op counter on an algorithm that gives the
right answer."""

from __future__ import annotations

import math

import numpy as np
import pytest

from twinbench.counts import calib_mape, des_place


def _calib_counted(u, real, cands):
    """The factored grid MAPE of ``cands`` ``[C, 3]`` over ``u`` ``[T, H]``,
    counting each arithmetic operation as it runs."""
    t_bins, hosts = u.shape
    n = 0
    s2 = [0.0] * t_bins
    logs = {}
    for t in range(t_bins):
        for h in range(hosts):
            logs[t, h] = math.log(max(u[t, h], 1e-30))
            s2[t] += 2.0 * u[t, h]
            n += 2
    sr = {}
    for r in sorted(set(cands[:, 2].tolist())):
        for t in range(t_bins):
            acc = 0.0
            for h in range(hosts):
                acc += math.exp(r * logs[t, h])
                n += 2
            sr[r, t] = acc
    out = []
    for p_idle, p_max, r in cands.tolist():
        total = 0.0
        for t in range(t_bins):
            sim = hosts * p_idle + (p_max - p_idle) * (s2[t] - sr[r, t])
            total += abs(real[t] - sim) * (1.0 / abs(real[t]))
            n += 6
        out.append(100.0 * total / t_bins)
    return np.array(out), n


@pytest.mark.parametrize("lanes,t_bins,hosts,rs,scales", [(1, 3, 4, 2, 2), (2, 5, 3, 3, 1)])
def test_calib_count_matches_a_counted_run(lanes, t_bins, hosts, rs, scales):
    rng = np.random.default_rng(lanes * 10 + t_bins)
    total = 0
    cands = None
    for _ in range(lanes):
        u = rng.random((t_bins, hosts)) * 0.9 + 0.05
        real = rng.random(t_bins) * 500 + 400
        r, s = np.linspace(1, 4, rs), np.linspace(0.9, 1.1, scales)
        rr, si, sm = np.meshgrid(r, s, s, indexing="ij")
        cands = np.stack([70 * si.ravel(), 350 * sm.ravel(), rr.ravel()], axis=1)
        got, n = _calib_counted(u, real, cands)
        direct = (cands[:, None, None, 0] + (cands[:, None, None, 1] - cands[:, None, None, 0])
                  * (2 * u[None] - u[None] ** cands[:, None, None, 2])).sum(-1)
        want = 100 * (np.abs(real[None] - direct) / real[None]).mean(-1)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        total += n
    c = cands.shape[0]
    assert total == calib_mape.ops(lanes=lanes, candidates=c, distinct_r=rs, bins=t_bins,
                                   hosts=hosts)
    arrays = [np.zeros((lanes, t_bins, hosts), np.float32), np.zeros((lanes, t_bins), np.float32),
              np.zeros((lanes, c, 3), np.float32), np.zeros((lanes, c), np.float32)]
    assert sum(a.nbytes for a in arrays) == calib_mape.nbytes(
        lanes=lanes, candidates=c, distinct_r=rs, bins=t_bins, hosts=hosts)


def _place_counted(dur, cores, hosts, cph, t_bins):
    """First fit of jobs submitted at bin 0, counting each host's release a
    bin and each host a placement scans."""
    n = 0
    free = [cph] * hosts
    release = [[0] * hosts for _ in range(t_bins + 1)]
    nxt = 0
    for t in range(t_bins):
        for h in range(hosts):
            free[h] += release[t][h]
            n += 1
        while nxt < len(dur):
            fit = None
            for h in range(hosts):
                n += 1
                if fit is None and free[h] >= cores[nxt]:
                    fit = h
            if fit is None:
                n -= hosts   # a blocked bin's scan places nothing
                break
            free[fit] -= cores[nxt]
            release[min(t + dur[nxt], t_bins)][fit] += cores[nxt]
            nxt += 1
    return n, nxt


@pytest.mark.parametrize("jobs,hosts,t_bins", [(6, 3, 5), (11, 4, 7)])
def test_des_place_count_matches_a_counted_run(jobs, hosts, t_bins):
    rng = np.random.default_rng(jobs)
    dur = rng.integers(1, 3, jobs).tolist()
    cores = rng.integers(1, 3, jobs).tolist()
    n, placed = _place_counted(dur, cores, hosts, 4, t_bins)
    assert placed == jobs
    assert n == des_place.ops(lanes=1, bins=t_bins, hosts=hosts, jobs=jobs)
    arrays = [np.zeros(jobs, np.int32)] * 3 + [np.zeros(jobs, bool), np.zeros(hosts, bool),
              np.zeros(hosts, bool), np.zeros(hosts, np.int32), np.zeros(hosts, np.int32),
              np.zeros(3, np.int32), np.zeros(jobs, np.int32), np.zeros(jobs, np.int32),
              np.zeros(1, np.int32)]
    assert sum(a.nbytes for a in arrays) == des_place.nbytes(lanes=1, bins=t_bins, hosts=hosts,
                                                              jobs=jobs)
