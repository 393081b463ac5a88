"""Fixed-timestep discrete-event datacenter simulation (port of ``repro.core.desim``).

The DES advances over 5-minute bins.  Per bin it releases the cores of
finished jobs, then places queued jobs FCFS with a bounded number of
placement attempts (head-of-line blocking, optionally relaxed by a bounded
backfill window), choosing each job's host with one of four placement
policies.  The utilization field, queue depth and running count are
reconstructed after the time loop from the job schedule.

Device layout: the scheduling state (free cores per host, the
``[t_bins + 1, H]`` core-release table, the online mask) lives on the
workload's device, and every fit test and host choice is computed there.
The loop itself is sequential and data-dependent: each placement attempt
ends in one device-to-host read of ``(head fits?, chosen host, ...)``, which
decides the next step on the host.  At the paper's SURF-SARA size (2016
bins, 5342 jobs) that is some 7-8 thousand synchronizing attempts per
horizon; a single-block CUDA placement kernel or a CUDA graph of the bin
step would remove them.  The immutable job arrays the loop's control flow
reads (submit bin, validity, cores, duration) are copied to the host once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.power import PowerParams
from repro_torch.kernels import ops
from repro_torch.traces.schema import SAMPLE_SECONDS, DatacenterConfig, Workload

Tensor = torch.Tensor

#: time-axis block size of the post-scan read-out (one day of bins)
_READOUT_BLOCK = 288

#: below this many [jobs, bins] elements the read-out runs in one pass
_READOUT_CHUNK_THRESHOLD = 4_000_000

FIRST_FIT = 0   #: lowest-indexed host that fits
BEST_FIT = 1    #: fitting host with the fewest free cores
WORST_FIT = 2   #: fitting host with the most free cores (the seed behavior)
RANDOM_FIT = 3  #: deterministic pseudo-random fitting host

PLACEMENT_POLICIES = {
    "first_fit": FIRST_FIT,
    "best_fit": BEST_FIT,
    "worst_fit": WORST_FIT,
    "random_fit": RANDOM_FIT,
}

POLICY_NAMES = {v: k for k, v in PLACEMENT_POLICIES.items()}

#: bias making best-fit scores positive (above the -1 "does not fit" sentinel)
_BEST_FIT_BIAS = 1 << 24

_M32 = 0xFFFFFFFF


def resolve_policy(policy: "str | int | None") -> int:
    """Map a policy name (or id) to its int id; ``None`` -> worst-fit."""
    if policy is None:
        return WORST_FIT
    if isinstance(policy, str):
        try:
            return PLACEMENT_POLICIES[policy]
        except KeyError:
            raise ValueError(
                f"unknown placement policy {policy!r}; "
                f"one of {sorted(PLACEMENT_POLICIES)}") from None
    p = int(policy)
    if p not in POLICY_NAMES:
        raise ValueError(f"policy id {p} not in {sorted(POLICY_NAMES)}")
    return p


def _mul32(x: Tensor, c: int) -> Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without overflow.

    Torch has no full uint32 arithmetic, so the JAX package's uint32 mixing
    is emulated in int64: the multiply is split at 16 bits so no partial
    product leaves the int64 range.
    """
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_scores(host_idx: Tensor, t: int, salt: int) -> Tensor:
    """Deterministic per-host pseudo-random scores for RANDOM_FIT.

    The seed-free integer mix of (bin, placement-count-within-bin, host
    index) of ``repro.core.desim._hash_scores``; int64 in, int64 out.
    """
    x = (_mul32(host_idx.to(torch.int64), 0x9E3779B1)
         ^ ((int(t) * 0x85EBCA77) & _M32)
         ^ ((int(salt) * 0xC2B2AE3D) & _M32))
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x & 0x7FFFFF


def _policy_score(free: Tensor, policy_id: int, t: int, salt: int,
                  idx: Tensor) -> Tensor:
    """The policy's ``[H]`` int64 host score (all >= 0; higher wins)."""
    h = idx.shape[0]
    if policy_id == FIRST_FIT:
        return h - idx
    if policy_id == BEST_FIT:
        return _BEST_FIT_BIAS - free.to(torch.int64).clamp(max=_BEST_FIT_BIAS - 1)
    if policy_id == WORST_FIT:
        return free.to(torch.int64)
    return _hash_scores(idx, t, salt)


def _policy_host(score: Tensor, fits: Tensor, idx: Tensor) -> Tensor:
    """Argmax of the score over fitting hosts; ties go to the lowest index.

    The tie-break is part of the key (``score * H + (H - 1 - idx)``) so it
    does not rest on how ``argmax`` orders equal values.  With no fitting
    host every key is ``-1 * H + ...`` and host 0 wins, as ``jnp.argmax``
    of an all ``-1`` row gives.
    """
    h = idx.shape[0]
    key = torch.where(fits, score, torch.full_like(score, -1)) * h + (h - 1 - idx)
    return key.argmax(dim=-1)


@dataclasses.dataclass(frozen=True)
class SimOutput:
    """Dense simulation read-out at 5-minute granularity.

    Attributes:
      u_th: ``[T, H]`` per-host utilization.
      queue_len: ``[T]`` jobs submitted but not yet started.
      running: ``[T]`` jobs running.
      job_start: ``[J]`` assigned start bin (-1 if never started).
      job_host: ``[J]`` assigned host (-1 if never started).
    """

    u_th: Tensor
    queue_len: Tensor
    running: Tensor
    job_start: Tensor
    job_host: Tensor


def _host_sums_in_job_order(busy: Tensor, num_hosts: int,
                            idx: Tensor | None) -> Tensor:
    """``[H, B]`` per-host sums of ``busy [J, B]``, deterministic.

    Each host adds its jobs' rows one at a time in job order (``idx`` is
    the ``[H, K]`` table of job ids per host, padded with the zero row J),
    the order of a sequential scatter-add, with no float atomics: the field
    has the same bits on every run and on every device.
    """
    b = busy.shape[1]
    if idx is None:
        return torch.zeros((num_hosts, b), dtype=busy.dtype, device=busy.device)
    padded = torch.cat([busy, torch.zeros((1, b), dtype=busy.dtype,
                                          device=busy.device)])
    gathered = padded[idx]                                   # [H, K, B]
    acc = gathered[:, 0]
    for k in range(1, idx.shape[1]):
        acc = acc + gathered[:, k]
    return acc


def _job_table(seg: Tensor, num_hosts: int) -> Tensor | None:
    """``[H, K]`` job ids per host in job order, padded with ``J``."""
    j = seg.shape[0]
    dev = seg.device
    seg_sorted, order = torch.sort(seg, stable=True)
    counts = torch.bincount(seg, minlength=num_hosts + 1)
    k = int(counts[:num_hosts].max()) if num_hosts else 0
    if k == 0:
        return None
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(j, device=dev) - starts[seg_sorted]
    keep = seg_sorted < num_hosts
    idx = torch.full((num_hosts, k), j, dtype=torch.int64, device=dev)
    idx[seg_sorted[keep], rank[keep]] = order[keep]
    return idx


def simulate_utilization_masked(
    w: Workload,
    host_mask: Tensor,
    cores_per_host: int,
    *,
    max_hosts: int,
    t_bins: int,
    max_starts_per_bin: int = 64,
    policy_id: "int | None" = None,
    backfill_depth: "int | None" = None,
    max_backfill: int = 0,
    force_chunked_readout: bool = False,
    fail_start: "Tensor | None" = None,
    fail_end: "Tensor | None" = None,
    fail_kill: "Tensor | None" = None,
) -> SimOutput:
    """Masked-host-axis DES core on the workload's device.

    ``host_mask [max_hosts]`` marks the active hosts; inactive hosts start
    with 0 free cores, never run jobs and report 0 utilization.

    ``policy_id`` picks the placement policy (:data:`PLACEMENT_POLICIES`,
    ``None`` -> worst-fit).  ``backfill_depth`` (clipped to the window
    ``max_backfill``, at most 31) lets up to that many queued successors of
    a capacity-blocked, submitted FCFS head start ahead of it, scanned in
    queue order; 0 is strict head-of-line blocking.

    Failure schedules (``fail_start``/``fail_end``/``fail_kill``, all
    ``[max_hosts]``, together or not at all): during
    ``[fail_start[h], fail_end[h])`` host ``h`` takes no new placements;
    with ``fail_kill[h]`` a job placed on it before the window that runs
    into it dies at ``fail_start`` and its cores return at ``fail_end``.
    Hosts that never fail carry the start sentinel ``int32.max``.
    """
    if not 0 <= max_backfill <= 31:
        raise ValueError(f"max_backfill must be in [0, 31], got {max_backfill}")
    if (fail_start is None) != (fail_end is None) or \
            (fail_start is None) != (fail_kill is None):
        raise ValueError(
            "fail_start/fail_end/fail_kill must be supplied together")
    dev = w.device
    j = w.num_jobs
    policy = WORST_FIT if policy_id is None else int(policy_id)
    depth = min(0 if backfill_depth is None else int(backfill_depth),
                max_backfill)
    cph = int(cores_per_host)

    # immutable job arrays the control flow reads, copied to the host once
    submit_h = w.submit_bin.cpu().numpy().astype(np.int64)
    valid_h = w.valid.cpu().numpy().astype(bool)
    cores_h = w.cores.cpu().numpy().astype(np.int64)
    dur_h = np.maximum(w.duration_bins.cpu().numpy().astype(np.int64), 1)

    host_mask = torch.as_tensor(host_mask, device=dev).to(torch.bool)
    idx = torch.arange(max_hosts, dtype=torch.int64, device=dev)
    failures = fail_start is not None
    if failures:
        fs = torch.as_tensor(fail_start, device=dev).to(torch.int32)
        fe = torch.as_tensor(fail_end, device=dev).to(torch.int32)
        fs_h = fs.cpu().numpy().astype(np.int64)
        fe_h = fe.cpu().numpy().astype(np.int64)
        fk_h = torch.as_tensor(fail_kill).cpu().numpy().astype(bool)

    free = torch.where(host_mask, cph, 0).to(torch.int32)
    release = torch.zeros((t_bins + 1, max_hosts), dtype=torch.int32, device=dev)
    job_start_h = np.full(j, -1, np.int64)
    job_host_h = np.full(j, -1, np.int64)
    next_job = 0
    skip = 0  # bit d set <=> job next_job+d already started via backfill
    d_off = np.arange(1, max_backfill + 1)

    def head_ready(nj: int, blocked: bool, t: int) -> bool:
        jid = min(nj, j - 1)
        return (nj < j and submit_h[jid] <= t and bool(valid_h[jid])
                and not blocked)

    for t in range(t_bins):
        # 1) completions: cores banked in the release table at placement
        free = free + release[t]
        if failures:
            online = host_mask & ~((fs <= t) & (t < fe))
        else:
            online = host_mask
        # 2) placement: each attempt places one job or blocks the bin
        n = 0
        blocked = False
        placed: list[tuple[int, int]] = []
        while head_ready(next_job, blocked, t) and n < max_starts_per_bin:
            jid_h = min(next_job, j - 1)
            score = _policy_score(free, policy, t, n, idx)
            fits_h = (free >= int(cores_h[jid_h])) & online
            parts = [fits_h.any()[None], _policy_host(score, fits_h, idx)[None]]
            if max_backfill > 0:
                cand = next_job + d_off
                jid_c = np.minimum(cand, j - 1)
                need_c = torch.as_tensor(cores_h[jid_c], device=dev)
                fits_c = (free[None, :] >= need_c[:, None]) & online[None, :]
                parts += [fits_c.any(dim=1), _policy_host(score, fits_c, idx)]
            res = torch.cat([p.to(torch.int64) for p in parts]).tolist()
            head_fits, host = bool(res[0]), int(res[1])
            if max_backfill > 0:
                k = max_backfill
                already = ((skip >> d_off) & 1).astype(bool)
                elig_c = ((cand < j) & (submit_h[jid_c] <= t) & valid_h[jid_c]
                          & ~already & (d_off <= depth))
                startable = elig_c & np.asarray(res[2:2 + k], bool)
                any_bf = bool(startable.any())
                d_sel = int(np.argmax(startable))
                place_bf = not head_fits and any_bf
                if not head_fits:
                    jid, host = int(jid_c[d_sel]), int(res[2 + k + d_sel])
                else:
                    jid = jid_h
            else:
                place_bf = False
                jid = jid_h
            do_place = head_fits or place_bf
            if do_place:
                free[host] -= int(cores_h[jid])
                placed.append((jid, host))
            if max_backfill > 0:
                if head_fits:
                    # advance past the head and any backfilled successors
                    next_job, skip = next_job + 1, skip >> 1
                    while skip & 1:
                        next_job, skip = next_job + 1, skip >> 1
                elif place_bf:
                    skip |= 1 << (d_sel + 1)
                blocked = blocked or (not head_fits and not any_bf)
            else:
                next_job += int(head_fits)
                blocked = blocked or not head_fits
            n += int(do_place)

        # 3) record this bin's placements and bank their core releases
        if placed:
            jids = np.array([p[0] for p in placed])
            hosts = np.array([p[1] for p in placed])
            job_start_h[jids] = t
            job_host_h[jids] = hosts
            end = t + dur_h[jids]
            if failures:
                killed = fk_h[hosts] & (t < fs_h[hosts]) & (end > fs_h[hosts])
                end = np.where(killed, fe_h[hosts], end)
            end = np.minimum(end, t_bins)
            release.index_put_(
                (torch.as_tensor(end, device=dev),
                 torch.as_tensor(hosts, device=dev)),
                torch.as_tensor(cores_h[jids], dtype=torch.int32, device=dev),
                accumulate=True)

    job_start = torch.as_tensor(job_start_h, dtype=torch.int32, device=dev)
    job_host = torch.as_tensor(job_host_h, dtype=torch.int32, device=dev)
    return _readout(w, job_start, job_host, max_hosts=max_hosts, t_bins=t_bins,
                    cores_per_host=cph, force_chunked=force_chunked_readout,
                    fail=(fs, fe, torch.as_tensor(fail_kill, device=dev))
                    if failures else None)


def _readout(w: Workload, job_start: Tensor, job_host: Tensor, *,
             max_hosts: int, t_bins: int, cores_per_host: int,
             force_chunked: bool, fail) -> SimOutput:
    """Utilization field, queue depth and running count from the schedule."""
    j = w.num_jobs
    dev = job_start.device
    u_phases = w.num_phases
    dur = w.duration_bins.to(torch.int32).clamp(min=1)
    started = job_start >= 0
    st = job_start[:, None]
    du = dur[:, None]
    seg = torch.where(started, job_host, max_hosts).to(torch.int64)
    if fail is not None:
        fs, _, fk = fail
        h_j = torch.where(started, job_host, 0).long()
        fs_j = fs[h_j][:, None]
        kill_j = (fk.to(torch.bool)[h_j] & started)[:, None]
        killed_j = kill_j & (st < fs_j) & (st + du > fs_j)
        end_eff = torch.where(killed_j, fs_j, st + du)
    else:
        end_eff = st + du
    table = _job_table(seg, max_hosts)
    cores_f = w.cores.to(w.util_levels.dtype)[:, None]
    submit = w.submit_bin[:, None]
    valid = w.valid[:, None]

    def block(tt: Tensor):
        # tt [B] with -1 padding past the horizon (matches nothing below)
        running = started[:, None] & (tt >= st) & (tt < end_eff)        # [J, B]
        phase = torch.div((tt - st) * u_phases, du.clamp(min=1),
                          rounding_mode="floor").clamp(0, u_phases - 1)
        u_job = torch.gather(w.util_levels, 1, phase.long())           # [J, B]
        busy = torch.where(running, u_job * cores_f, torch.zeros_like(u_job))
        host_busy = _host_sums_in_job_order(busy, max_hosts, table)
        u_b = host_busy.T / float(max(cores_per_host, 1))
        started_by_t = started[:, None] & (tt >= st)
        queued = ((submit <= tt) & valid & ~started_by_t).sum(dim=0)
        return u_b, queued.to(torch.int32), running.sum(dim=0).to(torch.int32)

    if not force_chunked and j * t_bins <= _READOUT_CHUNK_THRESHOLD:
        u_th, queued, running_ct = block(
            torch.arange(t_bins, dtype=torch.int32, device=dev))
    else:
        size = min(t_bins, _READOUT_BLOCK)
        n_blocks = -(-t_bins // size)
        tt_pad = torch.full((n_blocks * size,), -1, dtype=torch.int32, device=dev)
        tt_pad[:t_bins] = torch.arange(t_bins, dtype=torch.int32, device=dev)
        outs = [block(tt) for tt in tt_pad.view(n_blocks, size)]
        u_th = torch.cat([o[0] for o in outs])[:t_bins]
        queued = torch.cat([o[1] for o in outs])[:t_bins]
        running_ct = torch.cat([o[2] for o in outs])[:t_bins]
    return SimOutput(u_th=u_th.contiguous(), queue_len=queued,
                     running=running_ct, job_start=job_start,
                     job_host=job_host)


def simulate_utilization(
    w: Workload,
    *,
    num_hosts: int,
    cores_per_host: int,
    t_bins: int,
    max_starts_per_bin: int = 64,
    policy: "str | int | None" = None,
    backfill_depth: int = 0,
) -> SimOutput:
    """Run the DES with every host active; defaults are worst-fit FCFS."""
    return simulate_utilization_masked(
        w,
        torch.ones((num_hosts,), dtype=torch.bool, device=w.device),
        cores_per_host,
        max_hosts=num_hosts,
        t_bins=t_bins,
        max_starts_per_bin=max_starts_per_bin,
        policy_id=resolve_policy(policy),
        backfill_depth=backfill_depth,
        max_backfill=int(backfill_depth),
    )


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Multi-metric prediction for a window (NFR3: >=2 perf + >=2 sust.).

    The optional leaves are ``None`` when their input trace is absent.
    """

    power_w: Tensor        # [T] delivered power draw
    energy_kwh: Tensor     # [T] per-bin energy
    tflops: Tensor         # [T] achieved TFLOP/s
    utilization: Tensor    # [T] mean datacenter utilization
    efficiency: Tensor     # [T] TFLOPs per kWh
    gco2: Tensor | None = None
    power_demand_w: Tensor | None = None
    pue: Tensor | None = None
    energy_cost: Tensor | None = None


def predict_metrics(
    u_th: Tensor,
    params: PowerParams,
    dc: DatacenterConfig,
    model: str = "opendc",
    carbon_intensity: Tensor | None = None,
    ambient_c: Tensor | None = None,
    price: Tensor | None = None,
    pue=None,
) -> Prediction:
    """Map a utilization field to the paper's metric set (Fig. 5A/B/C).

    Always goes through the fused readout :func:`repro_torch.kernels.ops.des_readout`:
    the hand-written kernel for a field on the card, its plain version on
    the CPU.  ``carbon_intensity`` fills ``gco2``, ``pue`` (a
    :class:`repro_torch.traces.thermal.PUEParams`) turns the power trace
    into facility watts and fills ``pue``, ``price`` fills ``energy_cost``.
    """
    kw = {}
    if pue is not None:
        kw = dict(pue_base=pue.base, pue_amb_coeff=pue.amb_coeff,
                  pue_amb_ref=pue.amb_ref, pue_load_coeff=pue.load_coeff)
    rd = ops.des_readout(
        u_th, p_idle=params.p_idle, p_max=params.p_max, r=params.r,
        intensity=carbon_intensity, ambient=ambient_c, price=price,
        peak_tflops=dc.peak_tflops, model=model, dt_seconds=SAMPLE_SECONDS,
        **kw)
    return Prediction(
        power_w=rd["power_w"], energy_kwh=rd["energy_kwh"],
        tflops=rd["tflops"], utilization=rd["utilization"],
        efficiency=rd["efficiency"],
        gco2=None if carbon_intensity is None else rd["gco2"],
        pue=None if pue is None else rd["pue"],
        energy_cost=None if price is None else rd["energy_cost"])
