"""The DES placement of one lane, in NumPy (arXiv:2604.11445 §2.2; the
semantics of the port's ``des_place``, written again).

Per bin ``t``: the cores of jobs ending at ``t`` come back; then placement
attempts run while the FCFS head is submitted and valid, the bin is not
blocked and fewer than ``max_starts`` jobs started in it.  An attempt
places the head on the best-scoring online host that fits (ties to the
lowest index), or else the first of the head's next ``depth`` successors
that is submitted, valid, not started and fits somewhere (a backfill), or
else blocks the bin.  A job's cores come back at ``min(t + max(dur, 1),
T)``, or, when it lands before an outage of its host (``fail_kill``) and
runs into it, at the outage's end.
"""

from __future__ import annotations

import numpy as np

FIRST_FIT, BEST_FIT, WORST_FIT, RANDOM_FIT = range(4)
POLICIES = {"first_fit": FIRST_FIT, "best_fit": BEST_FIT,
            "worst_fit": WORST_FIT, "random_fit": RANDOM_FIT}
BEST_FIT_BIAS = 1 << 24
NEVER_BIN = np.iinfo(np.int32).max
_M32 = np.uint64(0xFFFFFFFF)


def _mul32(x: np.ndarray, c: int) -> np.ndarray:
    # x < 2**32 and c < 2**32: the product wraps mod 2**64, which keeps it
    # mod 2**32
    return (x * np.uint64(c)) & _M32


def hash_scores(idx: np.ndarray, t: int, salt: int) -> np.ndarray:
    """Random fit's seed-free score of each host: an integer mix of the
    bin, the placements so far in the bin and the host's index."""
    x = (_mul32(idx.astype(np.uint64), 0x9E3779B1)
         ^ np.uint64((t * 0x85EBCA77) & 0xFFFFFFFF)
         ^ np.uint64((salt * 0xC2B2AE3D) & 0xFFFFFFFF))
    x = _mul32(x ^ (x >> np.uint64(16)), 0x7FEB352D)
    x = _mul32(x ^ (x >> np.uint64(15)), 0x846CA68B)
    x = x ^ (x >> np.uint64(16))
    return (x & np.uint64(0x7FFFFF)).astype(np.int64)


def _score(free, policy, t, salt, idx, h):
    if policy == FIRST_FIT:
        return h - idx
    if policy == BEST_FIT:
        return BEST_FIT_BIAS - np.minimum(free, BEST_FIT_BIAS - 1)
    if policy == WORST_FIT:
        return free
    return hash_scores(idx, t, salt)


def _pick(score, fits, idx, h) -> int:
    return int(np.argmax(np.where(fits, score, -1) * h + (h - 1 - idx)))


def place_lane(submit, dur, cores, valid, host_mask, cores_per_host: int,
               policy: int, depth: int, *, t_bins: int, max_starts: int,
               max_backfill: int, fail=None) -> tuple[np.ndarray, np.ndarray, int]:
    """``(job_start, job_host, attempts)``: int64 ``[J]`` (-1: never
    started) and the count of attempts.  ``fail`` is ``(start, end, kill)``
    ``[H]`` rows or ``None``; ``depth`` is clipped to ``max_backfill``."""
    submit = np.asarray(submit, np.int64)
    dur1 = np.maximum(np.asarray(dur, np.int64), 1)
    cores = np.asarray(cores, np.int64)
    valid = np.asarray(valid, bool)
    mask = np.asarray(host_mask, bool)
    j, h = submit.shape[0], mask.shape[0]
    depth = min(int(depth), int(max_backfill))
    idx = np.arange(h, dtype=np.int64)
    if fail is not None:
        fs, fe, fk = (np.asarray(x) for x in fail)
        fs, fe, fk = fs.astype(np.int64), fe.astype(np.int64), fk.astype(bool)
    free = np.where(mask, int(cores_per_host), 0).astype(np.int64)
    release = np.zeros((t_bins + 1, h), np.int64)
    job_start = np.full(j, -1, np.int64)
    job_host = np.full(j, -1, np.int64)
    d_off = np.arange(1, max_backfill + 1)
    next_job, skip, attempts = 0, 0, 0
    for t in range(t_bins):
        free += release[t]
        online = mask & ~((fs <= t) & (t < fe)) if fail is not None else mask
        n, blocked, placed = 0, False, []
        while (not blocked and n < max_starts and next_job < j
               and submit[next_job] <= t and valid[next_job]):
            attempts += 1
            score = _score(free, policy, t, n, idx, h)
            fits = (free >= cores[next_job]) & online
            head_fits = bool(fits.any())
            jid, d_sel = next_job, 0
            if head_fits:
                host = _pick(score, fits, idx, h)
            elif max_backfill > 0:
                cand = next_job + d_off
                jc = np.minimum(cand, j - 1)
                fits_c = (free[None, :] >= cores[jc][:, None]) & online[None, :]
                already = ((skip >> d_off) & 1).astype(bool)
                ok = ((cand < j) & (submit[jc] <= t) & valid[jc] & ~already
                      & (d_off <= depth) & fits_c.any(axis=1))
                if ok.any():
                    d = int(np.argmax(ok))
                    jid, host, d_sel = int(jc[d]), _pick(score, fits_c[d], idx, h), d + 1
            if head_fits or d_sel:
                free[host] -= cores[jid]
                placed.append((jid, host))
                n += 1
            if head_fits:
                next_job, skip = next_job + 1, skip >> 1
                while skip & 1:
                    next_job, skip = next_job + 1, skip >> 1
            elif d_sel:
                skip |= 1 << d_sel
            else:
                blocked = True
        if placed:
            jids = np.array([p[0] for p in placed])
            hosts = np.array([p[1] for p in placed])
            job_start[jids] = t
            job_host[jids] = hosts
            end = t + dur1[jids]
            if fail is not None:
                killed = fk[hosts] & (t < fs[hosts]) & (end > fs[hosts])
                end = np.where(killed, fe[hosts], end)
            np.add.at(release, (np.minimum(end, t_bins), hosts), cores[jids])
    return job_start, job_host, attempts
