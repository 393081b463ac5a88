"""Fixed-timestep discrete-event datacenter simulation (port of ``repro.core.desim``).

The DES advances over 5-minute bins.  Per bin it releases the cores of
finished jobs, then places queued jobs FCFS with a bounded number of
placement attempts (head-of-line blocking, optionally relaxed by a bounded
backfill window), choosing each job's host with one of four placement
policies.  The utilization field, queue depth and running count are
reconstructed after the time loop from the job schedule.

Placement goes through :func:`repro_torch.kernels.ops.des_place`: on the
card one launch of the hand-written kernel places every lane (scenario) of
a batch, on the CPU its plain version runs lane by lane.  The lane axis is
explicit: workload leaves ``[S, J]`` and per-lane settings give outputs
with a leading ``S``, as the JAX package's ``jax.vmap`` of this function
over scenarios does; the unbatched call is the one-lane case.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.power import PowerParams
from repro_torch.kernels import ops
from repro_torch.traces.schema import SAMPLE_SECONDS, DatacenterConfig, Workload

Tensor = torch.Tensor

#: time-axis block size of the post-scan read-out (one day of bins)
_READOUT_BLOCK = 288

#: below this many [jobs, bins] elements per lane the read-out runs in one pass
_READOUT_CHUNK_THRESHOLD = 4_000_000

#: above this many [lanes, jobs, bins] elements a batched read-out is
#: chunked over time, as the JAX package's scenario engine chunks it
_BATCH_READOUT_THRESHOLD = 32_000_000

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


def _leaves(x) -> list:
    """A dataclass's fields in order (tensors or None), not copied."""
    return [getattr(x, f.name) for f in dataclasses.fields(x)]


def _host_sums_in_job_order(busy: Tensor, num_hosts: int,
                            idx: Tensor | None) -> Tensor:
    """``[H, B]`` per-host sums of ``busy [J, B]``, deterministic.

    Each host adds its jobs' rows one at a time in job order (``idx`` is
    the ``[H, K]`` table of job ids per host, padded with the zero row J,
    gathered one column at a time),
    the order of a sequential scatter-add, with no float atomics: the field
    has the same bits on every run and on every device.
    """
    b = busy.shape[1]
    if idx is None:
        return torch.zeros((num_hosts, b), dtype=busy.dtype, device=busy.device)
    padded = torch.cat([busy, torch.zeros((1, b), dtype=busy.dtype,
                                          device=busy.device)])
    acc = padded[idx[:, 0]]
    for k in range(1, idx.shape[1]):
        acc = acc + padded[idx[:, k]]
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
    cores_per_host: "int | Tensor",
    *,
    max_hosts: int,
    t_bins: int,
    max_starts_per_bin: int = 64,
    policy_id: "int | Tensor | None" = None,
    backfill_depth: "int | Tensor | None" = None,
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

    **Lane axis.**  With workload leaves ``[S, J]`` every argument may
    carry a leading ``S``: ``host_mask`` and the failure arrays ``[S,
    max_hosts]``, ``cores_per_host``, ``policy_id`` and ``backfill_depth``
    ``[S]`` (a scalar is shared by the lanes); ``max_backfill`` stays one
    number.  Every output leaf then leads with ``S``, each lane equal, bit
    for bit, to its unbatched run.  The read-out is chunked over time when
    ``force_chunked_readout`` is set or a lane's ``J * t_bins`` exceeds
    ``_READOUT_CHUNK_THRESHOLD`` or the batch's ``S * J * t_bins``
    exceeds ``_BATCH_READOUT_THRESHOLD``; chunking changes no bit.
    """
    placed = _place_masked(
        w, host_mask, cores_per_host, max_hosts=max_hosts, t_bins=t_bins,
        max_starts_per_bin=max_starts_per_bin, policy_id=policy_id,
        backfill_depth=backfill_depth, max_backfill=max_backfill,
        fail_start=fail_start, fail_end=fail_end, fail_kill=fail_kill)
    return _read_out_placed(placed, max_hosts=max_hosts, t_bins=t_bins,
                            force_chunked_readout=force_chunked_readout)


def _place_masked(w: Workload, host_mask, cores_per_host, *, max_hosts: int,
                  t_bins: int, max_starts_per_bin: int, policy_id, backfill_depth,
                  max_backfill: int, fail_start=None, fail_end=None,
                  fail_kill=None) -> tuple:
    """The placement half of :func:`simulate_utilization_masked`: its
    arguments in lane form and one ``des_place`` launch, no read on the
    host.  Returns ``(workload, job_start, job_host, cores_per_host,
    failure arrays or None, whether the call had a lane axis)`` for
    :func:`_read_out_placed`."""
    if not 0 <= max_backfill <= 31:
        raise ValueError(f"max_backfill must be in [0, 31], got {max_backfill}")
    if (fail_start is None) != (fail_end is None) or \
            (fail_start is None) != (fail_kill is None):
        raise ValueError(
            "fail_start/fail_end/fail_kill must be supplied together")
    dev = w.device
    lanes = w.submit_bin.dim() == 2
    if not lanes:
        w = Workload(*(None if x is None else x[None] for x in _leaves(w)))
    s, j = w.submit_bin.shape

    def per_lane(x, dtype) -> Tensor:
        x = torch.as_tensor(x, device=dev).to(dtype)
        return x.expand(s) if x.dim() == 0 else x

    def per_host(x, dtype) -> Tensor:
        x = torch.as_tensor(x, device=dev).to(dtype)
        return x.expand(s, max_hosts) if x.dim() == 1 else x

    mask = per_host(host_mask, torch.bool)
    cph = per_lane(cores_per_host, torch.int32)
    fail = None
    if fail_start is not None:
        fail = (per_host(fail_start, torch.int32), per_host(fail_end, torch.int32),
                per_host(fail_kill, torch.bool))
    job_start, job_host, _ = ops.des_place(
        w.submit_bin, w.duration_bins, w.cores, w.valid, mask, cph,
        per_lane(WORST_FIT if policy_id is None else policy_id, torch.int32),
        per_lane(0 if backfill_depth is None else backfill_depth, torch.int32),
        t_bins=t_bins, max_starts_per_bin=max_starts_per_bin,
        max_backfill=max_backfill,
        **({} if fail is None else dict(zip(("fail_start", "fail_end", "fail_kill"),
                                            fail))))
    return w, job_start, job_host, cph, fail, lanes


def _read_out_placed(placed: tuple, *, max_hosts: int, t_bins: int,
                     force_chunked_readout: bool) -> SimOutput:
    """The read-out half of :func:`simulate_utilization_masked` on
    :func:`_place_masked`'s result (it reads the host once)."""
    w, job_start, job_host, cph, fail, lanes = placed
    s, j = w.submit_bin.shape
    chunked = (force_chunked_readout or j * t_bins > _READOUT_CHUNK_THRESHOLD
               or s * j * t_bins > _BATCH_READOUT_THRESHOLD)
    out = _readout(w, job_start, job_host, max_hosts=max_hosts, t_bins=t_bins,
                   cores_per_host=cph, chunked=chunked, fail=fail)
    if lanes:
        return out
    return SimOutput(*(x[0] for x in _leaves(out)))


def _readout(w: Workload, job_start: Tensor, job_host: Tensor, *,
             max_hosts: int, t_bins: int, cores_per_host: Tensor,
             chunked: bool, fail) -> SimOutput:
    """Utilization field, queue depth and running count from the schedule.

    Lanes lead every input (workload leaves and schedule ``[S, J]``,
    ``cores_per_host [S]``, failure arrays ``[S, H]``).  The lanes are
    laid end to end: job ``k`` of lane ``s`` is row ``s * J + k`` and its
    host ``h`` segment ``s * H + h``, so each lane's host sums add its own
    jobs in job order, as its unbatched run does.
    """
    s, j = job_start.shape
    h = max_hosts
    dev = job_start.device
    u_phases = w.util_levels.shape[-1]
    dur = w.duration_bins.to(torch.int32).clamp(min=1).reshape(-1, 1)
    started = (job_start >= 0).reshape(-1)
    st = job_start.reshape(-1, 1)
    lane_base = (torch.arange(s, device=dev) * h)[:, None]
    seg = torch.where(job_start >= 0, job_host.long() + lane_base,
                      s * h).reshape(-1)
    if fail is not None:
        fs, _, fk = fail
        h_j = torch.where(job_start >= 0, job_host, 0).long()
        fs_j = torch.gather(fs, 1, h_j).reshape(-1, 1)
        kill_j = (torch.gather(fk, 1, h_j).reshape(-1) & started)[:, None]
        killed_j = kill_j & (st < fs_j) & (st + dur > fs_j)
        end_eff = torch.where(killed_j, fs_j, st + dur)
    else:
        end_eff = st + dur
    table = _job_table(seg, s * h)
    util = w.util_levels.reshape(s * j, u_phases)
    cores_f = w.cores.to(util.dtype).reshape(-1, 1)
    submit = w.submit_bin.reshape(-1, 1)
    valid = w.valid.reshape(-1, 1)
    per_core = cores_per_host.clamp(min=1).to(util.dtype)[:, None, None]

    def block(tt: Tensor):
        # tt [B] with -1 padding past the horizon (matches nothing below)
        b = tt.shape[0]
        running = started[:, None] & (tt >= st) & (tt < end_eff)        # [SJ, B]
        phase = torch.div((tt - st) * u_phases, dur,
                          rounding_mode="floor").clamp(0, u_phases - 1)
        u_job = torch.gather(util, 1, phase.long())                    # [SJ, B]
        busy = torch.where(running, u_job * cores_f, torch.zeros_like(u_job))
        host_busy = _host_sums_in_job_order(busy, s * h, table)        # [SH, B]
        u_b = host_busy.view(s, h, b).transpose(1, 2) / per_core       # [S, B, H]
        started_by_t = started[:, None] & (tt >= st)
        queued = ((submit <= tt) & valid & ~started_by_t).view(s, j, b).sum(dim=1)
        return (u_b, queued.to(torch.int32),
                running.view(s, j, b).sum(dim=1).to(torch.int32))

    if not chunked:
        u_th, queued, running_ct = block(
            torch.arange(t_bins, dtype=torch.int32, device=dev))
    else:
        size = min(t_bins, _READOUT_BLOCK)
        n_blocks = -(-t_bins // size)
        tt_pad = torch.full((n_blocks * size,), -1, dtype=torch.int32, device=dev)
        tt_pad[:t_bins] = torch.arange(t_bins, dtype=torch.int32, device=dev)
        outs = [block(tt) for tt in tt_pad.view(n_blocks, size)]
        u_th = torch.cat([o[0] for o in outs], dim=1)[:, :t_bins]
        queued = torch.cat([o[1] for o in outs], dim=1)[:, :t_bins]
        running_ct = torch.cat([o[2] for o in outs], dim=1)[:, :t_bins]
    return SimOutput(u_th=u_th.contiguous(), queue_len=queued.contiguous(),
                     running=running_ct.contiguous(), job_start=job_start,
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


def simulate(
    w: Workload,
    dc: DatacenterConfig,
    t_bins: int,
    params: PowerParams = PowerParams(),
    model: str = "opendc",
) -> tuple[SimOutput, Prediction]:
    """One-call trace-in, metrics-out simulation (FR2)."""
    sim = simulate_utilization(
        w,
        num_hosts=dc.num_hosts,
        cores_per_host=dc.cores_per_host,
        t_bins=t_bins,
    )
    return sim, predict_metrics(sim.u_th, params, dc, model=model)


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
