"""Plain PyTorch versions of the hand-written kernels.

These are the specifications the CUDA kernels in ``csrc/`` are held to:
the CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

#: bfloat16 is used only on the tflops/efficiency leaves of the readout
#: (the precision policy of ``repro.kernels.des_readout``).
BF16 = torch.bfloat16  # tracecheck: disable=TC005 — readout precision policy, perf leaves only

#: floor under the log in the exp/log power form (0**r -> ~0, never -inf)
LOG_FLOOR = 1e-30

#: output order of the fused readout, Prediction's array leaves
READOUT_FIELDS = ("power_w", "energy_kwh", "tflops", "utilization",
                  "efficiency", "gco2", "power_demand_w", "pue",
                  "energy_cost")

#: [candidates, bins, hosts] elements materialized per chunk of candidates
_CALIB_CHUNK_ELEMS = 1 << 24


def calib_mape_grid_ref(u_th: Tensor, real_power: Tensor, p_idle: Tensor,
                        p_max: Tensor, r: Tensor) -> Tensor:
    """Grid-search MAPE [%] of every candidate; ``[B, C]`` (or ``[C]``).

    ``u_th`` is ``[T, H]`` or batched ``[B, T, H]`` with ``real_power``
    ``[T]`` / ``[B, T]``; the candidates ``p_idle/p_max/r`` are ``[C]``,
    shared by every batch row, or ``[L, C]`` rows, row ``l`` serving the
    ``B / L`` consecutive batch rows of its group.  For candidate c:
    ``sim_t = H*p_idle_c + (p_max_c - p_idle_c) * (S2_t - Sr_t(c))`` with
    ``S2_t = sum_h 2u`` and ``Sr_t(c) = sum_h exp(r_c * log max(u, 1e-30))``
    over u clipped to [0, 1].  Zero-real bins are excluded from the mean
    and an all-zero row gives NaN for every candidate.  With candidate rows
    on the CPU, ``Sr`` is formed once per distinct ``r`` of a row (equal
    bits, as the kernel dedups them: a joint grid's 9216 candidates hold
    64 values); on the card every candidate's is formed, so that the call
    never waits for the device (``torch.unique`` would).
    """
    batched = u_th.dim() == 3
    u = u_th if batched else u_th[None]
    real = (real_power if batched else real_power[None]).float()
    u = u.float().clamp(0.0, 1.0)
    b, t, h = u.shape
    s2 = (2.0 * u).sum(dim=2)                                # [B, T]
    log_u = torch.log(u.clamp(min=LOG_FLOOR))                # [B, T, H]

    def sums(rr, log_u):
        """``sum_h exp(r * log u)`` of ``rr`` ``[C]`` over ``log_u`` ``[G, T, H]``:
        ``[C, G, T]``, in chunks of candidates."""
        g = log_u.shape[0]
        step = max(1, _CALIB_CHUNK_ELEMS // max(g * t * h, 1))
        return torch.cat([
            torch.exp(rr[c0:c0 + step, None, None, None] * log_u[None]).sum(dim=3)
            for c0 in range(0, rr.shape[0], step)], dim=0)

    if r.dim() == 1:
        sr = sums(r.float(), log_u)                          # [C, B, T]
        pi, pm = p_idle.float()[:, None], p_max.float()[:, None]
    else:
        group = b // r.shape[0]
        sr = log_u.new_empty((r.shape[1], b, t))
        for row, r_row in enumerate(r.float()):
            rows = slice(row * group, (row + 1) * group)
            if r_row.device.type != "cpu":
                sr[:, rows] = sums(r_row, log_u[rows])
                continue
            bits, slot = torch.unique(r_row.view(torch.int32), return_inverse=True)
            sr[:, rows] = sums(bits.view(torch.float32), log_u[rows])[slot]
        pi, pm = (x.float().repeat_interleave(group, dim=0).T for x in (p_idle, p_max))
    span = (pm - pi)[:, :, None]
    sim = h * pi[:, :, None] + span * (s2[None] - sr)        # [C, B, T]
    nonzero = real.abs() > 1e-9                              # [B, T]
    n_nz = nonzero.sum(dim=1)                                # [B]
    ape = ((real[None] - sim) / (real[None].abs() + 1e-9)).abs() * nonzero[None]
    out = ape.sum(dim=2).T * (100.0 / n_nz.clamp(min=1).float())[:, None]
    out = torch.where(n_nz[:, None] > 0, out, torch.full_like(out, float("nan")))
    return out if batched else out[0]


def shape_term(u: Tensor, r: Tensor, model: str) -> Tensor:
    """Power-curve shape term over pre-clipped ``u`` (exp/log opendc form)."""
    if model == "opendc":
        return 2.0 * u - torch.exp(r * torch.log(u.clamp(min=LOG_FLOOR)))
    if model == "linear":
        return u
    if model == "sqrt":
        return torch.sqrt(u)
    if model == "cubic":
        return u * u * u
    raise ValueError(f"unknown power model {model!r}")


def power_sim_constants(h: int, *, p_idle: float, p_max: float,
                        peak_tflops: float, dt_seconds: float) -> dict:
    """The kernel's f32 scalars, folded in double as the TPU kernel folds
    its static Python floats: ``H*p_idle``, ``p_max - p_idle``, the
    W -> kWh-per-bin factor and the TFLOP/s peak."""
    return dict(base=float(h * p_idle), span=float(p_max - p_idle),
                e_factor=float(dt_seconds / 3600.0 / 1000.0),
                peak=float(peak_tflops))


def power_sim_ref(u_th: Tensor, p_idle: float, p_max: float, r: float, *,
                  peak_tflops: float, dt_seconds: float
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Fleet power [W], energy [kWh] and TFLOP/s per bin: three ``[T]`` f32.

    The JAX package's parameters (``repro.kernels.ref.power_sim_ref``).
    Mirrors ``repro.kernels.power_sim._kernel`` on u clipped to [0, 1]:
    ``power = base + span * sum_h (2u - exp(r * log max(u, 1e-30)))``,
    ``energy = power * e_factor``, ``tflops = sum_h u / H * peak``, with
    the scalars of :func:`power_sim_constants` (the kernel's own
    arguments) folded in double and rounded to f32.
    """
    u = u_th.float().clamp(0.0, 1.0)
    h = u.shape[1]
    c = power_sim_constants(h, p_idle=float(p_idle), p_max=float(p_max),
                            peak_tflops=float(peak_tflops),
                            dt_seconds=float(dt_seconds))
    f32 = dict(dtype=torch.float32)
    rr, base_t, span_t, e_t, peak_t, h_t = (
        torch.tensor(v, **f32) for v in (float(r), c["base"], c["span"],
                                         c["e_factor"], c["peak"], h))
    shape = 2.0 * u - torch.exp(rr * torch.log(u.clamp(min=LOG_FLOOR)))
    power = base_t + span_t * shape.sum(dim=1)
    return power, power * e_t, u.sum(dim=1) / h_t * peak_t


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True,
                        scale: float | None = None,
                        return_lse: bool = False
                        ) -> Tensor | tuple[Tensor, Tensor]:
    """Plain attention with GQA head grouping: ``[B, Hq, Sq, Dv]`` in q's dtype.

    q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Skv, D]``, v ``[B, Hkv, Skv, Dv]``
    (a V head dim of its own, as MLA's); query head ``hi``
    reads KV head ``hi // (Hq / Hkv)``.  In f32 after the cast, q scaled
    after it; causal rows see keys ``j <= i + (Skv - Sq)``.  Mirrors
    ``repro.kernels.ref.flash_attention_ref``.  With ``return_lse`` also
    the rows' f32 log-sum-exp ``[B, Hq, Sq]``, ``m + log(max(l, 1e-30))``
    of the scaled logits as the kernel and the JAX package's
    ``_flash_fwd_scan`` clamp it (``-1e30`` for a row that sees no key).
    """
    b, hq, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None] + (skv - s)
        mask = rows >= torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)
    if not return_lse:
        return out
    # a row with a live key has l >= 1; one with none: m + log(1e-30) = -1e30
    return out, torch.logsumexp(logits, dim=-1).clamp(min=-1e30)


def ssd_chunk_ref(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                  c: Tensor, d_skip: Tensor) -> tuple[Tensor, Tensor]:
    """SSD intra-chunk term and chunk-end states, unfused, in float32.

    ``x [BC, Q, H, P]``, ``dt [BC, Q, H]`` (post-softplus), ``a_log [H]``,
    ``b/c [BC, Q, G, N]``, ``d_skip [H]`` -> ``(y_intra [BC, Q, H, P],
    states [BC, H, P, N])``; head ``h`` reads group ``h // (H / G)``.
    ``y_intra`` already holds ``D * x``.  Mirrors
    ``repro.kernels.ref.ssd_chunk_ref`` line for line, but for where the
    decay is masked (see below), which keeps its gradient finite.
    """
    q, h = x.shape[1], x.shape[2]
    rep = h // b.shape[2]
    xf = x.float()
    dtf = dt.float()
    a = -torch.exp(a_log.float())
    bb = b.float().repeat_interleave(rep, dim=2)             # [BC,Q,H,N]
    cc = c.float().repeat_interleave(rep, dim=2)
    da = dtf * a[None, None, :]
    csum = torch.cumsum(da, dim=1)                            # [BC,Q,H]
    seg = csum[:, :, None, :] - csum[:, None, :, :]           # [BC,Qi,Qj,H]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # masked before the exponential (the JAX package masks after it): the
    # same values, but above the diagonal seg > 0 can overflow exp to inf,
    # and the where's gradient would then be 0 * inf = NaN
    decay = torch.exp(seg.masked_fill(~mask[None, :, :, None], float("-inf")))
    cb = torch.einsum("bqhn,bkhn->bqkh", cc, bb)
    att = cb * decay * dtf[:, None, :, :]
    y = torch.einsum("bqkh,bkhp->bqhp", att, xf)
    y = y + xf * d_skip.float()[None, None, :, None]
    decay_end = torch.exp(csum[:, -1:, :] - csum) * dtf      # [BC,Q,H]
    st = torch.einsum("bqhp,bqh,bqhn->bhpn", xf, decay_end, bb)
    return y, st


def des_readout_ref(u_th: Tensor, *, p_idle, p_max, r, mask, fail_start,
                    fail_end, fail_kill, cap, intensity, ambient, price,
                    peak_tflops, pue_base, pue_load_coeff, pue_amb_coeff,
                    pue_amb_ref, model: str, precision: str,
                    dt_seconds: float) -> dict[str, Tensor]:
    """The fused per-bin readout, unfused: 9 ``[S, T]`` float32 leaves.

    ``u_th`` is ``[S, T, H]`` and the operands are as
    :func:`repro_torch.kernels.ops.pack_readout` gives them: host rows
    ``[S, H]`` (``p_idle/p_max/r`` f32, ``mask`` f32 0/1,
    ``fail_start/fail_end`` int32 with the ``int32.max`` never-fails
    sentinel, ``fail_kill`` f32 0/1), bin columns ``[S, T]`` (``cap`` with
    the ``+inf`` uncapped sentinel, ``intensity/ambient/price`` zeros when
    absent), lane scalars ``[S]``, each of them a tensor or one Python
    number.  The lanes broadcast, as ``jax.vmap`` of
    ``repro.kernels.des_readout._tile_readout`` over scenarios computes
    them, lane by lane.  The four host sums are float64 sums of exact
    terms rounded once to float32 (the JAX kernel's are float32 sums), so
    they do not depend on the order of summation and the kernel takes the
    same ones: the linear throttle cancels where a cap sits just above the
    idle floor, and there two float32 orders disagree beyond the
    tolerance.
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision policy {precision!r}")

    def val(x, dtype=torch.float32):
        # a Python number as a 0-d float32 (int32) host tensor: rounded like
        # the kernel's parameter, and used by device ops without a copy
        return x if isinstance(x, Tensor) else torch.tensor(x, dtype=dtype)

    def row(x, dtype=torch.float32):          # [S, H] -> [S, 1, H]
        x = val(x, dtype)
        return x[:, None, :] if x.dim() else x

    def lane(x):                              # [S] -> [S, 1]
        x = val(x)
        return x[:, None] if x.dim() else x

    u = u_th.float()
    t = u.shape[1]
    t_ids = torch.arange(t, dtype=torch.int32, device=u.device)[:, None]
    off = ((row(fail_kill) > 0.0) & (t_ids >= row(fail_start, torch.int32))
           & (t_ids < row(fail_end, torch.int32)))
    on = (torch.where(off, 0.0, 1.0) * row(mask)).expand(u.shape)   # [S, T, H]
    uc = u.clamp(0.0, 1.0)
    pi = row(p_idle)
    host_p = pi + (row(p_max) - pi) * shape_term(uc, row(r), model)
    # float64 sums of exact terms, rounded once, as the kernel takes them
    # (csrc/des_readout.cu): independent of the order of summation
    on_d = on.double()
    it_demand, idle_floor, u_on, n_on = (
        (x * on_d).sum(dim=-1).float() for x in
        (host_p.double(), pi.double(), u.double(), torch.ones((), dtype=torch.float64)))
    util_raw = u_on / n_on.clamp(min=1.0)                          # [S, T]
    cap, intensity, ambient, price = (val(x) for x in (cap, intensity, ambient,
                                                      price))
    peak, p_base, p_load, p_amb, p_ref = (
        lane(x) for x in (peak_tflops, pue_base, pue_load_coeff,
                          pue_amb_coeff, pue_amb_ref))
    load = util_raw.clamp(0.0, 1.0)
    pue = p_base + p_load * (1.0 - load)
    pue = pue + p_amb * (ambient - p_ref).clamp(min=0.0)
    demand = it_demand * pue
    floor = idle_floor * pue
    exceeded = demand > cap
    power = torch.minimum(demand, cap)
    throttle = ((cap - floor) / (demand - floor).clamp(min=1e-9)).clamp(0.0, 1.0)
    # a true division, as the kernel's: PyTorch on the card multiplies by
    # the reciprocal of a scalar divisor, which can round one ulp apart
    e = power * val(dt_seconds / 3600.0) / torch.full_like(power, 1000.0)
    util = torch.where(exceeded, util_raw * throttle, util_raw)
    if precision == "bf16":
        tf16 = util.to(BF16) * peak.to(BF16)
        eff = (tf16 / e.clamp(min=1e-9).to(BF16)).float()
        tflops = tf16.float()
    else:
        tflops = util * peak
        eff = tflops / e.clamp(min=1e-9)
    gco2 = e * intensity
    cost = e * price
    return dict(zip(READOUT_FIELDS,
                    (power, e, tflops, util, eff, gco2, demand, pue, cost)))


#: placement policy ids, as ``repro_torch.core.desim.PLACEMENT_POLICIES``
#: numbers them: first fit, best fit, worst fit, random fit
FIRST_FIT, BEST_FIT, WORST_FIT, RANDOM_FIT = range(4)

#: bias making best-fit scores positive (above the -1 "does not fit" sentinel)
BEST_FIT_BIAS = 1 << 24

_M32 = 0xFFFFFFFF


def _mul32(x: Tensor, c: int) -> Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without overflow.

    Torch has no full uint32 arithmetic, so the JAX package's uint32 mixing
    is emulated in int64: the multiply is split at 16 bits so no partial
    product leaves the int64 range.
    """
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_scores(host_idx: Tensor, t: int, salt: int) -> Tensor:
    """Deterministic per-host pseudo-random scores for random fit.

    The seed-free integer mix of (bin, placements so far in the bin, host
    index) of ``repro.core.desim._hash_scores``; int64 in, int64 out.
    """
    x = (_mul32(host_idx.to(torch.int64), 0x9E3779B1)
         ^ ((int(t) * 0x85EBCA77) & _M32)
         ^ ((int(salt) * 0xC2B2AE3D) & _M32))
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x & 0x7FFFFF


def _policy_score(free: Tensor, policy: int, t: int, salt: int,
                  idx: Tensor) -> Tensor:
    """The policy's ``[H]`` int64 host score (all >= 0; higher wins)."""
    h = idx.shape[0]
    if policy == FIRST_FIT:
        return h - idx
    if policy == BEST_FIT:
        return BEST_FIT_BIAS - free.to(torch.int64).clamp(max=BEST_FIT_BIAS - 1)
    if policy == WORST_FIT:
        return free.to(torch.int64)
    return hash_scores(idx, t, salt)


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


def _place_lane(submit, dur, cores, valid, mask, cph: int, policy: int,
                depth: int, fail, *, t_bins: int, max_starts: int,
                max_backfill: int) -> tuple[list, list, int]:
    """One lane of :func:`des_place_ref`: ``(job_start, job_host, attempts)``.

    The scheduling state (free cores, the release table, the online mask)
    lives on the lane's device and every fit test and host choice is
    computed there; each attempt reads ``(head fits?, chosen host, ...)``
    back to decide the next step.  The immutable job arrays the control
    flow reads are copied to the host once.
    """
    dev = mask.device
    j = submit.shape[0]
    max_hosts = mask.shape[0]
    submit_h = submit.cpu().numpy().astype(np.int64)
    valid_h = valid.cpu().numpy().astype(bool)
    cores_h = cores.cpu().numpy().astype(np.int64)
    dur_h = np.maximum(dur.cpu().numpy().astype(np.int64), 1)
    idx = torch.arange(max_hosts, dtype=torch.int64, device=dev)
    if fail is not None:
        fs, fe, fk = fail
        fs_h = fs.cpu().numpy().astype(np.int64)
        fe_h = fe.cpu().numpy().astype(np.int64)
        fk_h = fk.cpu().numpy().astype(bool)

    free = torch.where(mask, cph, 0).to(torch.int32)
    release = torch.zeros((t_bins + 1, max_hosts), dtype=torch.int32, device=dev)
    job_start = np.full(j, -1, np.int64)
    job_host = np.full(j, -1, np.int64)
    next_job, skip, attempts = 0, 0, 0  # skip bit d: job next_job + d started
    d_off = np.arange(1, max_backfill + 1)

    def head_ready(nj: int, t: int) -> bool:
        return nj < j and submit_h[nj] <= t and bool(valid_h[nj])

    for t in range(t_bins):
        # 1) completions: cores banked in the release table at placement
        free = free + release[t]
        online = mask & ~((fs <= t) & (t < fe)) if fail is not None else mask
        # 2) placement: each attempt places one job or blocks the bin
        n = 0
        blocked = False
        placed: list[tuple[int, int]] = []
        while not blocked and n < max_starts and head_ready(next_job, t):
            attempts += 1
            score = _policy_score(free, policy, t, n, idx)
            fits_h = (free >= int(cores_h[next_job])) & online
            parts = [fits_h.any()[None], _policy_host(score, fits_h, idx)[None]]
            if max_backfill > 0:
                cand = next_job + d_off
                jid_c = np.minimum(cand, j - 1)
                need_c = torch.as_tensor(cores_h[jid_c], device=dev)
                fits_c = (free[None, :] >= need_c[:, None]) & online[None, :]
                parts += [fits_c.any(dim=1), _policy_host(score, fits_c, idx)]
            res = torch.cat([p.to(torch.int64) for p in parts]).tolist()
            head_fits, host, jid, d_sel = bool(res[0]), int(res[1]), next_job, 0
            if not head_fits and max_backfill > 0:
                k = max_backfill
                already = ((skip >> d_off) & 1).astype(bool)
                startable = ((cand < j) & (submit_h[jid_c] <= t) & valid_h[jid_c]
                             & ~already & (d_off <= depth)
                             & np.asarray(res[2:2 + k], bool))
                if startable.any():
                    d_sel = int(np.argmax(startable))
                    jid, host = int(jid_c[d_sel]), int(res[2 + k + d_sel])
                    d_sel += 1
            if head_fits or d_sel:
                free[host] -= int(cores_h[jid])
                placed.append((jid, host))
                n += 1
            if head_fits:
                # advance past the head and any backfilled successors
                next_job, skip = next_job + 1, skip >> 1
                while skip & 1:
                    next_job, skip = next_job + 1, skip >> 1
            elif d_sel:
                skip |= 1 << d_sel
            else:
                blocked = True

        # 3) record this bin's placements and bank their core releases
        if placed:
            jids = np.array([p[0] for p in placed])
            hosts = np.array([p[1] for p in placed])
            job_start[jids] = t
            job_host[jids] = hosts
            end = t + dur_h[jids]
            if fail is not None:
                killed = fk_h[hosts] & (t < fs_h[hosts]) & (end > fs_h[hosts])
                end = np.where(killed, fe_h[hosts], end)
            end = np.minimum(end, t_bins)
            release.index_put_(
                (torch.as_tensor(end, device=dev),
                 torch.as_tensor(hosts, device=dev)),
                torch.as_tensor(cores_h[jids], dtype=torch.int32, device=dev),
                accumulate=True)
    return job_start, job_host, attempts


def des_place_ref(submit: Tensor, dur: Tensor, cores: Tensor, valid: Tensor,
                  host_mask: Tensor, cores_per_host: Tensor, policy_id: Tensor,
                  depth: Tensor, *, t_bins: int, max_starts_per_bin: int,
                  max_backfill: int, fail_start=None, fail_end=None,
                  fail_kill=None) -> tuple[Tensor, Tensor, Tensor]:
    """DES placement, lane by lane: ``(job_start [S, J], job_host [S, J],
    attempts [S])`` int32.

    Per lane ``s`` and bin ``t``: cores of jobs ending at ``t`` return;
    then placement attempts run while the FCFS head job is submitted and
    valid, the bin is not blocked and fewer than ``max_starts_per_bin``
    jobs were placed in it.  An attempt places the head on the best
    fitting online host of the lane's policy (ties to the lowest index;
    random fit salted with the placements so far in the bin), or else the
    first of the head's next ``min(depth[s], max_backfill)`` successors
    that is submitted, valid, not started and fits (a backfill), or else
    blocks the bin.  A job's cores come back at ``min(t + max(dur, 1),
    t_bins)``, or at its host's outage end when it lands before the
    outage (``fail_kill``) and runs into it.  Hosts in ``[fail_start,
    fail_end)`` take no placement; hosts with ``host_mask`` false none at
    all.  ``attempts`` counts the attempts (each places a job or blocks
    its bin).  ``csrc/des_place.cu`` computes the same, every lane in one
    launch.
    """
    lanes, j = submit.shape
    dev = submit.device
    job_start = torch.full((lanes, j), -1, dtype=torch.int32, device=dev)
    job_host = torch.full((lanes, j), -1, dtype=torch.int32, device=dev)
    attempts = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    policy = policy_id.clamp(0, 3).tolist()
    depth = depth.clamp(max=max_backfill).tolist()
    cph = cores_per_host.tolist()
    for s in range(lanes):
        fail = (None if fail_start is None else
                (fail_start[s].to(torch.int32), fail_end[s].to(torch.int32),
                 fail_kill[s].to(torch.bool)))
        js, jh, n = _place_lane(
            submit[s], dur[s], cores[s], valid[s], host_mask[s].to(torch.bool),
            int(cph[s]), int(policy[s]), int(depth[s]), fail, t_bins=t_bins,
            max_starts=max_starts_per_bin, max_backfill=max_backfill)
        job_start[s] = torch.as_tensor(js, dtype=torch.int32)
        job_host[s] = torch.as_tensor(jh, dtype=torch.int32)
        attempts[s] = n
    return job_start, job_host, attempts
