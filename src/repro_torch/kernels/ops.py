"""Public kernel wrappers: device dispatch, operand packing, launch counts.

Dispatch follows the tensor's device, never a fallback: a CUDA tensor
launches the hand-written kernel (and raises if that fails), a CPU tensor
runs the plain PyTorch version in :mod:`repro_torch.kernels.ref`.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.

The two LM kernels, ``flash_attention`` and ``ssd_chunk``, are also
``torch.library`` operators (``torch.ops.repro_torch.*``): a ``CUDA``
kernel (the hand-written launch, counted), a ``CPU`` kernel (the plain
version) and a ``Meta`` kernel that gives the output shapes on ``meta``
tensors, where nothing runs.  They are registered through the low-level
``torch.library.Library`` API, whose dispatch costs the host less than a
``torch.library.custom_op`` call's (``chip_smoke.py`` logs the cost).
Their FLOPs are registered with ``torch.utils.flop_counter``
(:func:`flash_attention_flops`, :func:`ssd_chunk_flops`), so a
``FlopCounterMode`` counts one call by the same formula on the card, the
CPU and ``meta``: the dry-run's meta pass (``analysis/cost.py``) and a
run on the card count alike.  The twin's kernels take no ``meta``
tensor: one raises there.

On DTensors (the per-device dry-run) the two LM operators run on each
device's shards by the sharding rules :func:`_flash_sharding` and
:func:`_ssd_sharding` give: split on the batch and on the (kv-)heads, or
on the SSM heads, a shard's kernel computes its block of the output, and
any other placement is first redistributed to one of those.  A flash
call split on its query rows never reaches the rule: a shard's keys
depend on its coordinate, so ``models.attention`` runs it per shard.  A
shard is charged by the same FLOP formula at its own shape.  ``des_place`` is a
``torch.library`` operator too (``CPU`` and ``CUDA`` kernels, no
``Meta`` one), charged by :func:`des_place_ops` (its operations, from
the call's attempts) beside its operand and result bytes: one op, on the
card and the CPU alike.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import flop_counter

from repro_torch.kernels import ref
from repro_torch.kernels.ref import READOUT_FIELDS
from repro_torch.kernels.calib_mape import calib_mape_grid_cuda, candidate_group
from repro_torch.kernels.des_place import MAX_BACKFILL, des_place_cuda
from repro_torch.kernels.des_readout import (
    COLUMNS,
    INT_OPERANDS,
    LANE_SCALARS,
    MODEL_IDS,
    PRECISION_IDS,
    ROWS,
    des_readout_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.power_sim import power_sim_cuda
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

Tensor = torch.Tensor

LAUNCHES: dict[str, int] = {"calib_mape_grid": 0, "des_readout": 0,
                            "power_sim": 0, "flash_attention": 0,
                            "ssd_chunk": 0, "des_place": 0}

#: failure-start sentinel of hosts that never fail
NEVER = int(np.iinfo(np.int32).max)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device_kind(x: Tensor, meta: bool = False) -> str:
    """``x``'s device type, ``cuda`` or ``cpu`` (or ``meta`` where the
    caller has a fake kernel); any other raises."""
    if x.device.type not in (("cuda", "cpu", "meta") if meta else ("cuda", "cpu")):
        raise ValueError(f"no kernel for tensors on {x.device}")
    return x.device.type


def calib_mape_grid(u_th: Tensor, real_power: Tensor, p_idle: Tensor,
                    p_max: Tensor, r: Tensor) -> Tensor:
    """Candidate MAPEs [%] over a cached utilization window.

    ``u_th`` ``[T, H]`` with ``real_power`` ``[T]`` gives ``[C]``; the
    batched form ``[B, T, H]`` / ``[B, T]`` gives ``[B, C]`` in one launch,
    with the candidates ``p_idle/p_max/r`` either ``[C]``, shared by every
    row, or ``[L, C]`` rows, row ``l`` serving the ``B / L`` consecutive
    batch rows of its group (a fleet's lanes, each with its own grid).
    """
    if u_th.dim() not in (2, 3) or real_power.dim() != u_th.dim() - 1:
        raise ValueError(
            f"u_th/real_power must be [T, H]/[T] or [B, T, H]/[B, T]; got "
            f"{tuple(u_th.shape)} / {tuple(real_power.shape)}")
    if r.dim() == 2 and u_th.dim() == 2:
        raise ValueError("candidate rows [L, C] need a batched [B, T, H] window")
    if r.dim() == 2:
        candidate_group(u_th.shape[0], r)
    if not p_idle.shape == p_max.shape == r.shape:
        raise ValueError(f"p_idle/p_max/r must share one shape; got "
                         f"{tuple(p_idle.shape)} / {tuple(p_max.shape)} / {tuple(r.shape)}")
    if _device_kind(u_th) == "cpu":
        return ref.calib_mape_grid_ref(u_th, real_power, p_idle, p_max, r)
    batched = u_th.dim() == 3
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    out = calib_mape_grid_cuda(
        f32(u_th if batched else u_th[None]),
        f32(real_power if batched else real_power[None]),
        f32(p_idle), f32(p_max), f32(r))
    LAUNCHES["calib_mape_grid"] += 1
    return out if batched else out[0]


def _uniform(x) -> bool:
    """A number the same for every lane, bin and host, read on the host."""
    if isinstance(x, Tensor):
        return x.dim() == 0 and x.device.type == "cpu"
    return np.ndim(x) == 0 and not isinstance(x, (str, bytes))


def pack_readout(
    u_th: Tensor,
    *,
    p_idle,
    p_max,
    r,
    mask=None,
    cap_t=None,
    intensity=None,
    ambient=None,
    price=None,
    peak_tflops=1.0,
    pue_base=1.0,
    pue_amb_coeff=0.0,
    pue_amb_ref=18.0,
    pue_load_coeff=0.0,
    fail_start=None,
    fail_end=None,
    fail_kill=None,
    model: str = "opendc",
    precision: str = "f32",
    dt_seconds: float = 300.0,
) -> tuple[Tensor, dict]:
    """The readout's operands, as both versions take them.

    ``u_th`` is ``[T, H]`` or, with a scenario (lane) axis, ``[S, T, H]``;
    it comes back as a contiguous float32 ``[S, T, H]`` (S = 1 for
    ``[T, H]``).  Operands broadcast by numpy's rules: host rows
    (``p_idle/p_max/r/mask/fail_*``) to ``[S, H]``, bin columns
    (``cap_t/intensity/ambient/price``) to ``[S, T]``, lane scalars
    (``peak_tflops`` and the PUE parameters) to ``[S]`` (a per-lane scalar
    of a row or column is ``[S, 1]``; ``[T, H]`` takes no lane axis).  Each
    comes back as a float32 (``fail_start``/``fail_end``: int32) view of
    that lane shape on ``u_th``'s device, stride 0 where it is shared, or,
    when it is one number (a Python or numpy scalar, a 0-d CPU tensor), as
    that Python number: no device tensor, no host-to-device copy.  Absent
    axes take the kernel's sentinels (no mask, ``+inf`` cap, zero
    carbon/price columns, hosts that never fail).
    """
    if model not in MODEL_IDS:
        raise ValueError(f"unknown power model {model!r}")
    if precision not in PRECISION_IDS:
        raise ValueError(f"unknown precision policy {precision!r}")
    if u_th.dim() not in (2, 3):
        raise ValueError(f"u_th must be [T, H] or [S, T, H], got {tuple(u_th.shape)}")
    if not u_th.is_floating_point():
        raise TypeError(f"u_th must be floating point, got {u_th.dtype}")
    dev = u_th.device
    lead = tuple(u_th.shape[:-2])
    t, h = u_th.shape[-2:]
    shapes = {**{k: (h,) for k in ROWS}, **{k: (t,) for k in COLUMNS},
              **{k: () for k in LANE_SCALARS}}

    def operand(name, x):
        is_int = name in INT_OPERANDS
        kind = "integer" if is_int else "real"
        if _uniform(x):
            x = x.item() if isinstance(x, Tensor) else np.asarray(x).item()
            if isinstance(x, complex) or (is_int and isinstance(x, float)):
                raise TypeError(f"{name} must be {kind}, got {x!r}")
            if is_int and not np.iinfo(np.int32).min <= x <= NEVER:
                raise ValueError(f"{name} {x} is outside int32")
            return int(x) if is_int else float(x)
        x = torch.as_tensor(x, device=dev)
        if x.is_complex() or (is_int and x.is_floating_point()):
            raise TypeError(f"{name} must be {kind}, got {x.dtype}")
        want = lead + shapes[name]
        try:
            x = x.to(torch.int32 if is_int else torch.float32).broadcast_to(want)
        except RuntimeError:
            raise ValueError(f"{name} of shape {tuple(x.shape)} does not "
                             f"broadcast to {want}") from None
        return x if lead else x[None]

    given = dict(
        p_idle=p_idle, p_max=p_max, r=r, mask=1.0 if mask is None else mask,
        fail_start=NEVER if fail_start is None else fail_start,
        fail_end=0 if fail_end is None else fail_end,
        fail_kill=0.0 if fail_kill is None else fail_kill,
        cap=float("inf") if cap_t is None else cap_t,
        intensity=0.0 if intensity is None else intensity,
        ambient=0.0 if ambient is None else ambient,
        price=0.0 if price is None else price,
        peak_tflops=peak_tflops, pue_base=pue_base,
        pue_load_coeff=pue_load_coeff, pue_amb_coeff=pue_amb_coeff,
        pue_amb_ref=pue_amb_ref)
    operands = {k: operand(k, x) for k, x in given.items()}
    operands.update(model=model, precision=precision, dt_seconds=float(dt_seconds))
    u = u_th.to(torch.float32).contiguous()
    return (u if lead else u[None]), operands


def des_readout(u_th: Tensor, **kw) -> dict[str, Tensor]:
    """Fused DES readout: ``{field: f32}`` for every ``READOUT_FIELDS``.

    ``u_th`` ``[T, H]`` gives ``[T]`` leaves; ``[S, T, H]`` gives ``[S, T]``
    leaves, lane by lane as the JAX package's ``jax.vmap`` of its kernel
    over scenarios, in one launch.  Keyword operands as
    :func:`pack_readout` takes them.
    """
    kind = _device_kind(u_th)
    u, operands = pack_readout(u_th, **kw)
    if kind == "cpu":
        out = ref.des_readout_ref(u, **operands)
    elif u.shape[0] * u.shape[1] == 0:
        out = dict(zip(READOUT_FIELDS, u.new_empty((len(READOUT_FIELDS),
                                                    *u.shape[:2])).unbind(0)))
    else:
        out = des_readout_cuda(u, **operands)
        LAUNCHES["des_readout"] += 1
    return out if u_th.dim() == 3 else {k: v[0] for k, v in out.items()}


def power_sim(u_th: Tensor, *, p_idle: float, p_max: float, r: float,
              peak_tflops: float, dt_seconds: float
              ) -> tuple[Tensor, Tensor, Tensor]:
    """Fused fleet ``(power [W], energy [kWh], tflops)`` per bin, three ``[T]``.

    ``u_th`` ``[T, H]``; the power parameters are fleet scalars.
    """
    if u_th.dim() != 2:
        raise ValueError(f"u_th must be [T, H], got {tuple(u_th.shape)}")
    kind = _device_kind(u_th)
    u = u_th.to(torch.float32).contiguous()
    if kind == "cpu":
        return ref.power_sim_ref(u, p_idle, p_max, r, peak_tflops=peak_tflops,
                                 dt_seconds=dt_seconds)
    consts = ref.power_sim_constants(
        u_th.shape[1], p_idle=p_idle, p_max=p_max, peak_tflops=peak_tflops,
        dt_seconds=dt_seconds)
    out = power_sim_cuda(u, r=float(r), **consts)
    LAUNCHES["power_sim"] += 1
    return out


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a row block attends: ``Sq Skv`` without the mask;
    with it (row ``i`` sees keys ``j <= i + Skv - Sq``) ``Sq (Sq + 1) / 2 +
    Sq (Skv - Sq)``, or ``Skv (Skv + 1) / 2`` where ``Skv < Sq``."""
    if not causal:
        return sq * skv
    if skv >= sq:
        return sq * (sq + 1) // 2 + sq * (skv - sq)
    return skv * (skv + 1) // 2


def flash_attention_flops(b: int, hq: int, sq: int, skv: int, d: int, dv: int,
                          causal: bool) -> int:
    """FLOPs of the flash forward: ``S = Q K^T`` (2 D a pair) and ``P V``
    (2 Dv a pair) over the unmasked (query, key) pairs of every (batch
    row, query head).  The one formula for the op's count and the kernel's
    bound."""
    return 2 * (d + dv) * b * hq * causal_pairs(sq, skv, causal)


def ssd_chunk_flops(bc: int, q: int, h: int, p: int, g: int, n: int) -> int:
    """FLOPs of the SSD chunk's products over the causal triangle (``tri =
    Q (Q + 1) / 2`` pairs): ``C B^T`` once a (chunk, group), ``att @ x`` a
    head, and the chunk-end states ``x^T (decay * B)``."""
    tri = q * (q + 1) // 2
    return 2 * bc * g * tri * n + 2 * bc * h * tri * p + 2 * bc * h * q * p * n


def _no_lse(out: Tensor) -> Tensor:
    """The empty lse the op returns where none was asked for."""
    return out.new_empty((0,), dtype=torch.float32)


def _flash_cpu(q, k, v, causal, scale, return_lse):
    # contiguous, as the kernel's and the meta kernel's outputs are: a
    # later reshape then copies on no device
    if return_lse:
        out, lse = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                           return_lse=True)
        return out.contiguous(), lse.contiguous()
    out = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale).contiguous()
    return out, _no_lse(out)


def _flash_cuda(q, k, v, causal, scale, return_lse):
    out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, scale=scale, return_lse=return_lse)
    LAUNCHES["flash_attention"] += 1
    return out if return_lse else (out, _no_lse(out))


def _flash_meta(q, k, v, causal, scale, return_lse):
    b, hq, sq, _ = q.shape
    out = q.new_empty((b, hq, sq, v.shape[-1]))
    lse = (q.new_empty((b, hq, sq), dtype=torch.float32) if return_lse
           else _no_lse(out))
    return out, lse


def _flash_op_flops(q_shape, k_shape, v_shape, causal, scale, return_lse, *,
                    out_shape=None, **kwargs) -> int:
    b, hq, sq, d = q_shape
    return flash_attention_flops(b, hq, sq, k_shape[2], d, v_shape[3], causal)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: float | None = None, return_lse: bool = False
                    ) -> Tensor | tuple[Tensor, Tensor]:
    """GQA flash-attention forward: ``[B, Hq, Sq, Dv]`` in q's dtype.

    q ``[B, Hq, Sq, D]``, k ``[B, Hkv, Skv, D]``, v ``[B, Hkv, Skv, Dv]``
    (any strides; the V head dim may differ from the QK one, as MLA's
    does).  On the card every pair with ``1 <= D, Dv <= 256`` runs, one
    launch a call: the kernel's ``HEAD_DIM_PAIRS`` on their own
    instantiations, any other padded to the instantiation
    ``flash_attention.instantiation_for`` picks, its padding zero-filled
    inside the kernel; a wider head dim raises ``ValueError``.  The
    default ``scale`` is ``D ** -0.5`` of the true ``D``.  With
    ``return_lse``: ``(out, lse)``, ``lse`` ``[B, Hq, Sq]`` float32, the
    rows' log-sum-exp of the scaled logits (what the backward of
    ``models.attention`` reads), from the same launch.  ``meta`` tensors
    give ``meta`` outputs of those shapes.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Hq, Sq, D], got {tuple(q.shape)}")
    _device_kind(q, meta=True)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), scale,
                                                     bool(return_lse))
    return (out, lse) if return_lse else out


def _ssd_cpu(x, dt, a_log, b, c, d_skip):
    y, states = ref.ssd_chunk_ref(x, dt, a_log, b, c, d_skip)
    return y.contiguous(), states.contiguous()


def _ssd_cuda(x, dt, a_log, b, c, d_skip):
    out = ssd_chunk_cuda(x.contiguous(), dt.contiguous(), a_log, b.contiguous(),
                         c.contiguous(), d_skip)
    LAUNCHES["ssd_chunk"] += 1
    return out


def _ssd_meta(x, dt, a_log, b, c, d_skip):
    bc, q, h, p = x.shape
    return (x.new_empty((bc, q, h, p), dtype=torch.float32),
            x.new_empty((bc, h, p, b.shape[-1]), dtype=torch.float32))


def _ssd_op_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, d_shape, *,
                  out_shape=None, **kwargs) -> int:
    bc, q, h, p = x_shape
    return ssd_chunk_flops(bc, q, h, p, b_shape[2], b_shape[3])


_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
            "bool return_lse) -> (Tensor, Tensor)")
_LIB.define("ssd_chunk(Tensor x, Tensor dt, Tensor a_log, Tensor b, Tensor c, "
            "Tensor d_skip) -> (Tensor, Tensor)")
for _name, _kernels, _formula in (
        ("flash_attention", (_flash_cpu, _flash_cuda, _flash_meta), _flash_op_flops),
        ("ssd_chunk", (_ssd_cpu, _ssd_cuda, _ssd_meta), _ssd_op_flops)):
    for _key, _fn in zip(("CPU", "CUDA", "Meta"), _kernels):
        _LIB.impl(_name, _fn, _key)
    flop_counter.register_flop_formula(getattr(torch.ops.repro_torch, _name))(_formula)


def _divides(n: int, spec) -> bool:
    """Whether every axis of ``spec``'s mesh divides ``n`` or is larger
    than it (a strategy is given for one mesh axis and tried on each;
    DTensor drops it on an axis larger than the dim, and an axis that
    splits ``n`` unevenly would split the groups)."""
    return all(n % s == 0 or s > n for s in spec.mesh.shape)


def _flash_sharding(q, k, v, causal, scale, return_lse):
    """DTensor strategies of ``flash_attention``: ``(outputs, inputs)``
    placements a mesh axis.  Replicated; split on the batch; split on the
    heads where every mesh axis divides the kv heads (a query head's kv
    head then lies on its shard).  Never on a sequence: a row's keys span
    it, and a query-row shard's causal prefix depends on its coordinate,
    which a rule's local call cannot carry (``models.attention`` runs
    that split per shard, ``flash_rows``)."""
    from torch.distributed.tensor import Replicate, Shard

    rep = Replicate()
    out = [([rep, rep], [rep, rep, rep, None, None, None])]
    for d in (0, 1):
        if d == 1 and not _divides(k.shape[1], k):
            continue
        lse = Shard(d) if return_lse else rep
        out.append(([Shard(d), lse], [Shard(d)] * 3 + [None] * 3))
    return out


def _ssd_sharding(x, dt, a_log, b, c, d_skip):
    """DTensor strategies of ``ssd_chunk``: replicated; split on the chunk
    rows (batch x chunks); split on the SSM heads (``a_log``/``d_skip``
    with them, ``b``/``c`` on their groups where there is more than one,
    where every mesh axis divides the groups, else replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    rep = Replicate()
    g = b.shape[2]
    out = [([rep, rep], [rep] * 6),
           ([Shard(0), Shard(0)], [Shard(0), Shard(0), rep, Shard(0), Shard(0), rep])]
    if g == 1 or _divides(g, b):
        bc = rep if g == 1 else Shard(2)
        out.append(([Shard(2), Shard(1)], [Shard(2), Shard(2), Shard(0), bc, bc, Shard(0)]))
    return out


_SHARDING_REGISTERED = []


def register_sharding_rules() -> None:
    """Give DTensor the two operators' strategies (once a process; the
    DTensor package is imported here, where a device mesh is first made,
    not by importing this module)."""
    if _SHARDING_REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.flash_attention.default)(_flash_sharding)
    register_sharding(torch.ops.repro_torch.ssd_chunk.default)(_ssd_sharding)
    _SHARDING_REGISTERED.append(True)


def ssd_chunk(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
              d_skip: Tensor) -> tuple[Tensor, Tensor]:
    """Mamba2/SSD intra-chunk term (``D * x`` included) and chunk-end states.

    ``x [BC, Q, H, P]``, ``dt [BC, Q, H]``, ``a_log [H]``, ``b/c [BC, Q, G,
    N]``, ``d_skip [H]`` -> ``(y_intra [BC, Q, H, P], states [BC, H, P, N])``
    in float32.  On the card x, dt, b and c must be float32.  ``meta``
    tensors give ``meta`` outputs of those shapes.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [BC, Q, H, P], got {tuple(x.shape)}")
    _device_kind(x, meta=True)
    y, states = torch.ops.repro_torch.ssd_chunk(x, dt, a_log, b, c, d_skip)
    return y, states


def des_place(submit: Tensor, dur: Tensor, cores: Tensor, valid: Tensor,
              host_mask: Tensor, cores_per_host: Tensor, policy_id: Tensor,
              depth: Tensor, *, t_bins: int, max_starts_per_bin: int = 64,
              max_backfill: int = 0, fail_start=None, fail_end=None,
              fail_kill=None) -> tuple[Tensor, Tensor, Tensor]:
    """DES placement of S lanes: ``(job_start, job_host)`` ``[S, J]`` and
    the placement attempts ``[S]``, int32, in one launch.

    Job arrays ``[S, J]`` (submit bin, duration, cores, valid), the active
    hosts ``host_mask [S, H]``, ``cores_per_host``, ``policy_id`` (clipped
    to the four policies) and ``depth`` (clipped to ``max_backfill``, at
    most 31) ``[S]``, and the failure arrays ``[S, H]`` (start, end, kill;
    all three or none).  The rules are :func:`ref.des_place_ref`'s.
    """
    if not 0 <= max_backfill <= MAX_BACKFILL:
        raise ValueError(f"max_backfill must be in [0, {MAX_BACKFILL}], got {max_backfill}")
    fails = (fail_start, fail_end, fail_kill)
    if any(x is None for x in fails) and any(x is not None for x in fails):
        raise ValueError("fail_start/fail_end/fail_kill must be supplied together")
    if submit.dim() != 2 or host_mask.dim() != 2:
        raise ValueError(f"submit must be [S, J] and host_mask [S, H]; got "
                         f"{tuple(submit.shape)} / {tuple(host_mask.shape)}")
    s, j = submit.shape
    h = host_mask.shape[1]
    want = dict(dur=(s, j), cores=(s, j), valid=(s, j), host_mask=(s, h),
                cores_per_host=(s,), policy_id=(s,), depth=(s,),
                fail_start=(s, h), fail_end=(s, h), fail_kill=(s, h))
    given = dict(dur=dur, cores=cores, valid=valid, host_mask=host_mask,
                 cores_per_host=cores_per_host, policy_id=policy_id, depth=depth,
                 fail_start=fail_start, fail_end=fail_end, fail_kill=fail_kill)
    for k, x in given.items():
        if x is not None and tuple(x.shape) != want[k]:
            raise ValueError(f"{k} must be {want[k]}, got {tuple(x.shape)}")
    if h == 0 or t_bins < 0 or max_starts_per_bin < 0:
        raise ValueError(f"need H > 0, t_bins >= 0 and max_starts_per_bin >= 0; "
                         f"got {h}, {t_bins}, {max_starts_per_bin}")
    _device_kind(submit)
    return torch.ops.repro_torch.des_place(
        submit, dur, cores, valid, host_mask, cores_per_host, policy_id, depth,
        int(t_bins), int(max_starts_per_bin), int(max_backfill), fail_start, fail_end,
        fail_kill)


def _place_kw(t_bins, max_starts_per_bin, max_backfill, fail_start, fail_end, fail_kill):
    return dict(t_bins=t_bins, max_starts_per_bin=max_starts_per_bin,
                max_backfill=max_backfill, fail_start=fail_start, fail_end=fail_end,
                fail_kill=fail_kill)


def _place_cpu(*args):
    return ref.des_place_ref(*args[:8], **_place_kw(*args[8:]))


def _place_cuda(*args):
    s, j = args[0].shape
    dev = args[0].device
    if s * j == 0:
        return (torch.full((s, j), -1, dtype=torch.int32, device=dev),
                torch.full((s, j), -1, dtype=torch.int32, device=dev),
                torch.zeros((s,), dtype=torch.int32, device=dev))
    out = des_place_cuda(*args[:8], **_place_kw(*args[8:]))
    LAUNCHES["des_place"] += 1
    return out


def des_place_ops(attempts: int, s: int, t_bins: int, h: int) -> int:
    """Operations charged to one ``des_place`` call: every placement
    attempt (``attempts``, summed over the lanes) and every lane's bin (its
    release of ended jobs) visits each of the ``h`` hosts once.  The work
    depends on the data, so the count is this call's."""
    return (attempts + s * t_bins) * h


def _place_op_ops(submit, dur, cores, valid, host_mask, cores_per_host, policy_id, depth,
                  t_bins, max_starts_per_bin, max_backfill, fail_start=None, fail_end=None,
                  fail_kill=None, *, out_val=None, **kwargs) -> int:
    return des_place_ops(int(out_val[2].sum()), submit.shape[0], t_bins, host_mask.shape[1])


_LIB.define("des_place(Tensor submit, Tensor dur, Tensor cores, Tensor valid, "
            "Tensor host_mask, Tensor cores_per_host, Tensor policy_id, Tensor depth, "
            "int t_bins, int max_starts_per_bin, int max_backfill, Tensor? fail_start, "
            "Tensor? fail_end, Tensor? fail_kill) -> (Tensor, Tensor, Tensor)")
_LIB.impl("des_place", _place_cpu, "CPU")
_LIB.impl("des_place", _place_cuda, "CUDA")
flop_counter.register_flop_formula(torch.ops.repro_torch.des_place, get_raw=True)(_place_op_ops)
