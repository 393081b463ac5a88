"""Plain PyTorch versions of the hand-written kernels.

These are the specifications the CUDA kernels in ``csrc/`` are held to:
the CPU path of :mod:`repro_torch.kernels.ops` runs them, the tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.
"""

from __future__ import annotations

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
    ``[T]`` / ``[B, T]``; the candidates ``p_idle/p_max/r`` are ``[C]`` and
    shared by every batch row.  For candidate c:
    ``sim_t = H*p_idle_c + (p_max_c - p_idle_c) * (S2_t - Sr_t(c))`` with
    ``S2_t = sum_h 2u`` and ``Sr_t(c) = sum_h exp(r_c * log max(u, 1e-30))``
    over u clipped to [0, 1].  Zero-real bins are excluded from the mean
    and an all-zero row gives NaN for every candidate.
    """
    batched = u_th.dim() == 3
    u = u_th if batched else u_th[None]
    real = (real_power if batched else real_power[None]).float()
    u = u.float().clamp(0.0, 1.0)
    b, t, h = u.shape
    s2 = (2.0 * u).sum(dim=2)                                # [B, T]
    log_u = torch.log(u.clamp(min=LOG_FLOOR))                # [B, T, H]
    rr = r.float()
    step = max(1, _CALIB_CHUNK_ELEMS // max(b * t * h, 1))
    sr = torch.cat([
        torch.exp(rr[c0:c0 + step, None, None, None] * log_u[None]).sum(dim=3)
        for c0 in range(0, rr.shape[0], step)], dim=0)        # [C, B, T]
    pi, pm = p_idle.float(), p_max.float()
    span = (pm - pi)[:, None, None]
    sim = h * pi[:, None, None] + span * (s2[None] - sr)     # [C, B, T]
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


def power_sim_ref(u_th: Tensor, *, r: float, base: float, span: float,
                  e_factor: float, peak: float
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """Fleet power [W], energy [kWh] and TFLOP/s per bin: three ``[T]`` f32.

    Mirrors ``repro.kernels.power_sim._kernel`` on u clipped to [0, 1]:
    ``power = base + span * sum_h (2u - exp(r * log max(u, 1e-30)))``,
    ``energy = power * e_factor``, ``tflops = sum_h u / H * peak``, with
    the scalars of :func:`power_sim_constants` rounded to f32.
    """
    u = u_th.float().clamp(0.0, 1.0)
    h = u.shape[1]
    f32 = dict(dtype=torch.float32)
    rr, base_t, span_t, e_t, peak_t, h_t = (
        torch.tensor(v, **f32) for v in (r, base, span, e_factor, peak, h))
    shape = 2.0 * u - torch.exp(rr * torch.log(u.clamp(min=LOG_FLOOR)))
    power = base_t + span_t * shape.sum(dim=1)
    return power, power * e_t, u.sum(dim=1) / h_t * peak_t


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True,
                        scale: float | None = None) -> Tensor:
    """Plain attention with GQA head grouping: ``[B, Hq, Sq, D]`` in q's dtype.

    q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``; query head ``hi``
    reads KV head ``hi // (Hq / Hkv)``.  In f32 after the cast, q scaled
    after it; causal rows see keys ``j <= i + (Skv - Sq)``.  Mirrors
    ``repro.kernels.ref.flash_attention_ref``.
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
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)


def ssd_chunk_ref(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor,
                  c: Tensor, d_skip: Tensor) -> tuple[Tensor, Tensor]:
    """SSD intra-chunk term and chunk-end states, unfused, in float32.

    ``x [BC, Q, H, P]``, ``dt [BC, Q, H]`` (post-softplus), ``a_log [H]``,
    ``b/c [BC, Q, G, N]``, ``d_skip [H]`` -> ``(y_intra [BC, Q, H, P],
    states [BC, H, P, N])``; head ``h`` reads group ``h // (H / G)``.
    ``y_intra`` already holds ``D * x``.  Mirrors
    ``repro.kernels.ref.ssd_chunk_ref`` line for line.
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
    decay = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0)
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
