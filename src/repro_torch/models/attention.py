"""Attention: the flash kernel for prefill, a chunked online softmax over a
partially filled cache, and cache decode.  GQA throughout.

Layout: q [B, S, Hq, D]; k/v [B, Skv, Hkv, D], as in the JAX package.
With no cache lengths, :func:`chunked_attention` runs the flash-attention
kernel (:func:`repro_torch.kernels.ops.flash_attention`, on the kernel's
[B, H, S, D] layout): a CUDA tensor launches the hand-written kernel, a
CPU tensor runs its plain version, as ``kernel_backend`` switches the JAX
package between Pallas and XLA.

Training goes through :class:`FlashAttention`, the counterpart of the JAX
package's custom VJP ``_flash``: the forward is the same kernel call,
which also writes each row's log-sum-exp, and the backward is the
flash-attention-2 backward of ``_flash_vjp_bwd`` in plain torch, per KV
chunk, recomputing each chunk's scores instead of keeping them.

The JAX package's sharding constraints (``activation``) stand at their
counterparts: moving nothing on plain tensors, they place the DTensors of
the per-device dry-run.  Where the mesh's ``model`` axis divides the kv
heads, the flash call splits on them (the operator's DTensor rule).
Where it does not, the query rows split over ``model`` (the JAX
package's ``attn_q_seq``, its context-parallel fallback) and K and V stay
whole there: shard ``r`` of ``tp`` holds the rows ``[r m, (r + 1) m)``,
``m = Sq / tp``, contiguous as XLA splits JAX's scan, and attends the
causal prefix of the keys, ``[0, (r + 1) m + Skv - Sq)`` (all of them
without the mask), so the kernel's bottom-right diagonal falls on the
shard's own rows with no offset argument (:func:`flash_rows`,
:func:`flash_rows_backward`).  Each device runs its shard through
``sharding.on_shards``: a shard's keys depend on its coordinate, which a
DTensor sharding rule cannot carry.  Where ``model`` does not divide
``Sq`` (or a causal call has fewer keys than queries), the split drops,
as JAX's ``logical_to_spec`` drops it, and the call runs replicated.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import (
    activation,
    current_ctx,
    is_dtensor,
    kernel_placements,
    on_shards,
    shard_einsum,
    softmax_last,
    splits,
    use_ctx,
)

Tensor = torch.Tensor

NEG_INF = -1e30


def _axes(hkv: int) -> tuple[tuple, tuple]:
    """The JAX package's ``(q_axes, acc_axes)``: the grouped query
    ``[B, S, Hkv, G, D]`` and the accumulator ``[B, Hkv, G, S, Dv]`` split
    on the kv heads where the ambient mesh's ``model`` axis divides them,
    else on the query rows (``attn_q_seq``)."""
    mesh = current_ctx().mesh
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if hkv % tp == 0:
        return ("batch", None, "kv_heads", None, None), ("batch", "kv_heads", None, None, None)
    return ("batch", "attn_q_seq", None, None, None), ("batch", None, None, "attn_q_seq", None)


def chunked_attention(
    q: Tensor, k: Tensor, v: Tensor,
    *,
    causal: bool = True,
    kv_chunk: int = 1024,
    scale: float | None = None,
    kv_len: Tensor | None = None,
) -> Tensor:
    """Online-softmax attention over KV chunks.

    kv_len: optional [B] active cache lengths (decode with a partially
    filled cache); positions >= kv_len are masked out.
    """
    b, s, hq, d = q.shape
    _, t, hkv, _ = k.shape
    dv = v.shape[-1]                      # may differ from d (MLA)
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    q_axes, acc_axes = _axes(hkv)
    if kv_len is None:
        if q_axes[2] is not None:
            q = activation(q, "batch", None, "kv_heads", None)
        elif not causal or t >= s:
            # the query rows over 'model', K and V whole there
            q = activation(q, "batch", "attn_q_seq", None, None)
            k = activation(k, "batch", None, "kv_heads", None)
            v = activation(v, "batch", None, "kv_heads", None)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            out = FlashAttention.apply(qt, kt, vt, causal, scale, kv_chunk)
        else:
            out = flash_forward(qt, kt, vt, causal, scale, False)[0]
        return out.transpose(1, 2)

    qg = activation((q * scale).reshape(b, s, hkv, g, d), *q_axes)
    n_chunks = max(t // kv_chunk, 1)
    kv_chunk = t // n_chunks
    if t % kv_chunk:
        raise ValueError(f"cache length {t} is not a multiple of the KV "
                         f"chunk {kv_chunk}")
    out = _flash_fwd_scan(qg, k, v, causal, kv_chunk, t, s, acc_axes, kv_len)
    return (out.permute(0, 3, 1, 2, 4).reshape(b, s, hkv * g, dv)
            .to(q.dtype))


def query_seq_axis(hkv: int) -> str:
    """The logical axis of an attention's query rows: ``attn_q_seq`` where
    the ambient mesh's ``model`` axis does not divide the kv heads (the
    rows then split over it, module docstring), else ``seq``."""
    return _axes(hkv)[0][1] or "seq"


def _prefix(m: int, skv: int, r: int, tp: int, causal: bool) -> int:
    """The keys shard ``r`` of ``tp`` query-row shards of ``m`` rows
    attends: the causal prefix ``(r + 1) m + Skv - Sq`` (``Sq = tp m``),
    or all ``Skv`` without the mask."""
    return (r + 1) * m + skv - tp * m if causal else skv


def flash_rows(q: Tensor, k: Tensor, v: Tensor, r: int, tp: int, *, causal: bool,
               scale: float, return_lse: bool = False
               ) -> Tensor | tuple[Tensor, Tensor]:
    """Shard ``r`` of a flash call split into ``tp`` blocks of query rows:
    q ``[B, Hq, m, D]`` the rows ``[r m, (r + 1) m)`` of a call of ``tp m``
    rows, k/v ``[B, Hkv, Skv, D]`` whole.  The kernel (its plain version
    on a CPU tensor) on the keys the rows attend (:func:`_prefix`): its
    diagonal, bottom-right aligned, falls on the shard's rows.  The
    output (and lse) are those rows of the unsplit call's."""
    n = _prefix(q.shape[2], k.shape[2], r, tp, causal)
    return kops.flash_attention(q, k[:, :, :n], v[:, :, :n], causal=causal, scale=scale,
                                return_lse=return_lse)


def flash_rows_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                        dout: Tensor, r: int, tp: int, *, causal: bool, scale: float,
                        kv_chunk: int = 1024) -> tuple[Tensor, Tensor, Tensor]:
    """The gradient of :func:`flash_rows`: :func:`flash_backward` over the
    shard's keys, ``dq`` its rows', ``dk``/``dv`` of all ``Skv`` keys,
    zero past the prefix.  ``dq`` of the ``tp`` shards put together, and
    their ``dk``/``dv`` summed, are the unsplit call's."""
    skv = k.shape[2]
    n = _prefix(q.shape[2], skv, r, tp, causal)
    dq, dk, dv = flash_backward(q, k[:, :, :n], v[:, :, :n], out, lse, dout,
                                causal=causal, scale=scale, kv_chunk=kv_chunk)
    if n < skv:
        dk, dv = F.pad(dk, (0, 0, 0, skv - n)), F.pad(dv, (0, 0, 0, skv - n))
    return dq, dk, dv


def _row_split(q: Tensor) -> tuple[int, int, int] | None:
    """``(mesh dim, shard, shards)`` of DTensor ``q [B, H, S, D]`` split
    on its query rows, or None.  The shard is this rank's coordinate on
    that mesh dim, but in the dry-run's ``fake`` group, whose one rank
    stands for every device, the last: it attends the most keys, and a
    step waits for its slowest device."""
    if not splits(q, 2):
        return None
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    dm = q.device_mesh
    dim = next(i for i, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 2)
    tp = dm.size(dim)
    if dist.get_backend(dm.get_group(dim)) == "fake":
        return dim, tp - 1, tp
    return dim, dm.get_local_rank(dim), tp


def _row_placements(q: Tensor, k: Tensor, dim: int) -> tuple[list, list]:
    """The placements a row-split flash call's operands take: q (out,
    lse) split on the rows over mesh dim ``dim``, k and v whole there;
    on every other mesh dim as the operator's rule places them."""
    from torch.distributed.tensor import Replicate, Shard

    pl = kernel_placements(q, 1, k.shape[1])
    rows, kv = list(pl), list(pl)
    rows[dim], kv[dim] = Shard(2), Replicate()
    return rows, kv


def flash_forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, scale: float,
                  return_lse: bool) -> tuple[Tensor, ...]:
    """``ops.flash_attention`` on the kernel's layout, ``(out, lse)`` (the
    lse only with ``return_lse``).  A DTensor q split on its query rows
    runs :func:`flash_rows` on each device's shards (module docstring)."""
    split = _row_split(q)
    if split is None:
        res = kops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=return_lse)
        return res if return_lse else (res,)
    dim, r, tp = split
    rows, kv = _row_placements(q, k, dim)
    b, hq, sq, _ = q.shape

    def shard(q_, k_, v_):
        res = flash_rows(q_, k_, v_, r, tp, causal=causal, scale=scale,
                         return_lse=return_lse)
        return res if return_lse else (res,)

    outs = [(rows, torch.Size((b, hq, sq, v.shape[-1])))]
    if return_lse:
        outs.append((rows, torch.Size((b, hq, sq))))
    return on_shards(shard, [q, k, v], [rows, kv, kv], outs)


class FlashAttention(torch.autograd.Function):
    """Flash attention on the kernel's ``[B, H, S, D]`` layout, with a
    gradient: ``apply(q, k, v, causal, scale, kv_chunk)``.

    ``forward`` is :func:`flash_forward` with the lse (the kernel on a
    CUDA tensor, its plain version on a CPU one) and keeps q, k, v, the
    output and the lse.  ``backward`` is :func:`flash_backward`, under the
    forward's ``ShardingCtx`` (the autograd engine's thread for a card has
    none bound); on DTensors on each device's shards, placed as the
    forward placed them (its views would split dims no shard can view):
    on a query-row split :func:`flash_rows_backward`, whose ``dk``/``dv``
    are partial sums over the rows' mesh dim.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_chunk):
        out, lse = flash_forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kv_chunk = causal, scale, kv_chunk
        ctx.sharding = current_ctx()
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale, kv_chunk=ctx.kv_chunk)
        if is_dtensor(q):       # on each device's shards, as the forward ran them
            split = _row_split(q)
            if split is None:
                pl = kernel_placements(q, 1, k.shape[1])
                fn, ins, outs = functools.partial(flash_backward, **kw), [pl] * 6, [pl] * 3
            else:
                from torch.distributed.tensor import Partial

                dim, r, tp = split
                rows, kv = _row_placements(q, k, dim)
                part = list(kv)
                part[dim] = Partial()
                fn = functools.partial(flash_rows_backward, r=r, tp=tp, **kw)
                ins, outs = [rows, kv, kv, rows, rows, rows], [rows, part, part]
            grads = on_shards(fn, [q, k, v, out, lse, dout], ins,
                              list(zip(outs, (q.shape, k.shape, v.shape))))
            return grads + (None,) * 3
        with use_ctx(ctx.sharding):
            dq, dk, dv = flash_backward(q, k, v, out, lse, dout, **kw)
        return dq, dk, dv, None, None, None


def flash_backward(q: Tensor, k: Tensor, v: Tensor, out: Tensor, lse: Tensor,
                   dout: Tensor, *, causal: bool, scale: float,
                   kv_chunk: int = 1024) -> tuple[Tensor, Tensor, Tensor]:
    """The flash-attention-2 backward of the JAX package's
    ``_flash_vjp_bwd``: ``(dq, dk, dv)`` in the inputs' dtypes.

    q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]``, ``out`` the forward's
    output, ``lse`` ``[B, Hq, Sq]`` its rows' log-sum-exp over the scaled
    logits.  ``delta = sum dO * O`` per row, then per KV chunk of
    ``kv_chunk`` keys: ``p = exp(s - lse)``, ``ds = p (dp - delta)``, with
    dq, dk and dv summed in float32.  ``out`` is the forward's output in
    q's dtype, where JAX keeps its f32 accumulator: in float32 the two
    are the same.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.float().reshape(b, hkv, g, sq, d) * scale
    do = activation(dout.float().reshape(b, hkv, g, sq, v.shape[-1]), *_axes(hkv)[1])
    delta = (do * out.float().reshape(do.shape)).sum(dim=-1, keepdim=True)
    lse = lse.reshape(b, hkv, g, sq, 1)
    q_pos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for c0 in range(0, skv, kv_chunk):
        kb = k[:, :, c0:c0 + kv_chunk].float()                 # [B, Hkv, C, D]
        vb = v[:, :, c0:c0 + kv_chunk].float()
        # in place: a chunk holds two [B, Hkv, G, Sq, C] f32 buffers, p and ds
        p = torch.einsum("bhgsd,bhcd->bhgsc", qg, kb)
        if causal:
            k_pos = c0 + torch.arange(kb.shape[2], device=dev)[None, :]
            p.masked_fill_(~(q_pos >= k_pos), NEG_INF)
        p.sub_(lse).exp_()                                     # normalized probs
        ds = torch.einsum("bhgsd,bhcd->bhgsc", do, vb).sub_(delta).mul_(p)
        dq = dq + torch.einsum("bhgsc,bhcd->bhgsd", ds, kb)
        dks.append(torch.einsum("bhgsc,bhgsd->bhcd", ds, qg))
        dvs.append(torch.einsum("bhgsc,bhgsd->bhcd", p, do))
    dq = (dq.to(q.dtype) * scale).reshape(q.shape)
    return dq, torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


def _flash_fwd_scan(qg: Tensor, k: Tensor, v: Tensor, causal: bool,
                    kv_chunk: int, t: int, s: int, acc_axes: tuple,
                    kv_len: Tensor | None = None) -> Tensor:
    """Online-softmax forward over KV chunks: out [b, hkv, g, s, dv] f32."""
    b, _, hkv, g, _ = qg.shape
    dv = v.shape[-1]
    dev = qg.device
    q_pos = torch.arange(s, device=dev)[:, None] + (t - s)
    acc = activation(torch.zeros((b, hkv, g, s, dv), dtype=torch.float32, device=dev),
                     *acc_axes)
    m = activation(torch.full((b, hkv, g, s, 1), NEG_INF, dtype=torch.float32, device=dev),
                   *acc_axes)
    l = activation(torch.zeros((b, hkv, g, s, 1), dtype=torch.float32, device=dev),
                   *acc_axes)
    for c0 in range(0, t, kv_chunk):
        kb = k[:, c0:c0 + kv_chunk]                   # [B, C, Hkv, D]
        vb = v[:, c0:c0 + kv_chunk]
        logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), kb.float())
        k_pos = c0 + torch.arange(kv_chunk, device=dev)[None, :]
        if causal:
            logits = logits.masked_fill(~(q_pos >= k_pos), NEG_INF)
        if kv_len is not None:
            live = k_pos < kv_len[:, None]                       # [B, C]
            logits = logits.masked_fill(~live[:, None, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = activation(acc * alpha + torch.einsum("bhgsc,bchd->bhgsd", p, vb.float()),
                         *acc_axes)
        m = m_new
    return acc / l.clamp(min=1e-30)


def _cache_rule(second: int, heads: bool = True):
    """:func:`parallel.sharding.shard_einsum`'s placements for a cache
    ``[B, T, Hkv, D]`` (or MLA's latent ``[B, T, L]``, ``heads`` False) on
    one mesh axis: rows with rows, kv heads with the ``[B, Hkv, ...]``
    operand's heads, the sequence with the logits' last dim (``second``:
    the product over it, a partial sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def rule(p):
        if isinstance(p, Shard) and p.dim == 0:
            return Shard(0), p, Shard(0)
        if heads and isinstance(p, Shard) and p.dim == 2:
            return Shard(1), p, Shard(1)
        if isinstance(p, Shard) and p.dim == 1:
            return (Replicate(), p, Shard(3)) if not second else (Shard(3), p, Partial())
        return Replicate(), Replicate(), Replicate()

    return rule


def _decode(q: Tensor, k_cache: Tensor, v_cache: Tensor, cache_len: Tensor | None,
            scale: float) -> Tensor:
    """:func:`decode_attention` on plain tensors (or one device's shards)."""
    b, _, hq, d = q.shape
    _, t, hkv, _ = k_cache.shape
    qg = (q * scale).reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    if cache_len is not None:
        live = torch.arange(t, device=q.device)[None] < cache_len[:, None]
        logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _decode_on_shards(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                      cache_len: Tensor | None, scale: float) -> Tensor:
    """:func:`_decode` on each device's shards of a DTensor cache whose
    sequence is whole: the rows with the cache's rows, the query heads
    with its kv heads (a kv-head shard's queries are one block of the
    query heads), anything else gathered.  No DTensor op runs, so no
    head regroup or product needs a DTensor rule."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = k_cache.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in k_cache.placements]
    args, pls = [q, k_cache, v_cache], [pl, pl, pl]
    if cache_len is not None:
        if not is_dtensor(cache_len):
            cache_len = DTensor.from_local(cache_len, dm, [Replicate()] * dm.ndim,
                                           run_check=False)
        args.append(cache_len)
        pls.append([p if p == Shard(0) else Replicate() for p in pl])

    def local(ql, kl, vl, ll=None):
        return (_decode(ql, kl, vl, ll, scale),)

    return on_shards(local, args, pls, [(pl, q.shape)])[0]


def decode_attention(
    q: Tensor,         # [B, 1, Hq, D]
    k_cache: Tensor,   # [B, T, Hkv, D]
    v_cache: Tensor,
    *,
    cache_len: Tensor | None = None,    # [B] live lengths
    scale: float | None = None,
) -> Tensor:
    """Single-token attention against the cache: one product over it.

    The logits are the f32 products of the operands (``q`` scaled in its
    own dtype), as the JAX package asks for them.  On a DTensor cache
    split on its sequence (the serve rules' ``cache_seq``) the cache stays
    split: each shard's products over its block of the cache
    (``shard_einsum``; DTensor's einsum merges the split dim and gathers
    the cache), the softmax of the shards (``softmax_last``: a max and a
    sum all-reduced as rows, where DTensor's softmax gathers the logits)
    with each key masked at its global position, and the second product a
    partial sum, as XLA partitions JAX's one einsum.  On any other DTensor
    cache each device runs the plain steps on its shards.
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    if not is_dtensor(k_cache):
        return _decode(q, k_cache, v_cache, cache_len, scale)
    if not splits(k_cache, 1):
        return _decode_on_shards(q, k_cache, v_cache, cache_len, scale)
    from torch.distributed.tensor import Replicate, Shard

    b, _, hq, _ = q.shape
    _, t, hkv, _ = k_cache.shape
    # every sequence shard needs every head: q's heads are gathered where
    # the cache's are whole, so the regroup views a tensor split on rows
    heads = [isinstance(p, Shard) and p.dim == 2 for p in k_cache.placements]
    q_pl = [p if not (isinstance(p, Shard) and p.dim == 2) or h else Replicate()
            for p, h in zip(q.placements, heads)]
    if q_pl != list(q.placements):
        q = q.redistribute(q.device_mesh, q_pl)
    qg = (q * scale).reshape(b, hkv, hq // hkv, d)
    logits = shard_einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float(), _cache_rule(0))
    if cache_len is not None:
        live = torch.arange(t, device=q.device)[None] < cache_len[:, None]
        logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    probs = softmax_last(logits)
    out = shard_einsum("bhgt,bthd->bhgd", probs, v_cache.float(), _cache_rule(1))
    return out.reshape(b, 1, hq, d).to(q.dtype)
