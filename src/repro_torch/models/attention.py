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
the per-device dry-run.  The flash kernel has no context-parallel form,
so where the mesh's ``model`` axis does not divide the kv heads its query
takes no ``attn_q_seq`` constraint (the JAX package's scan splits the
query rows there; the kernel's rule runs the heads replicated).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import (
    activation,
    current_ctx,
    is_dtensor,
    kernel_placements,
    on_shards,
    shard_einsum,
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
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            out = FlashAttention.apply(qt, kt, vt, causal, scale, kv_chunk)
        else:
            out = kops.flash_attention(qt, kt, vt, causal=causal, scale=scale)
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


class FlashAttention(torch.autograd.Function):
    """Flash attention on the kernel's ``[B, H, S, D]`` layout, with a
    gradient: ``apply(q, k, v, causal, scale, kv_chunk)``.

    ``forward`` is ``ops.flash_attention(..., return_lse=True)`` (the
    kernel on a CUDA tensor, its plain version on a CPU one) and keeps q,
    k, v, the output and the lse.  ``backward`` is :func:`flash_backward`,
    under the forward's ``ShardingCtx`` (the autograd engine's thread for
    a card has none bound); on DTensors on each device's shards, placed as
    the forward's sharding rule places them (its views would split dims
    no shard can view).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_chunk):
        out, lse = kops.flash_attention(q, k, v, causal=causal, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.kv_chunk = causal, scale, kv_chunk
        ctx.sharding = current_ctx()
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = functools.partial(flash_backward, causal=ctx.causal, scale=ctx.scale,
                                kv_chunk=ctx.kv_chunk)
        if is_dtensor(q):       # on each device's shards, as the forward's rule runs it
            pl = kernel_placements(q, 1, k.shape[1])
            return on_shards(bwd, [q, k, v, out, lse, dout], [pl] * 6,
                             [(pl, q.shape), (pl, k.shape), (pl, v.shape)]) + (None,) * 3
        with use_ctx(ctx.sharding):
            dq, dk, dv = bwd(q, k, v, out, lse, dout)
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
        logits = torch.einsum("bhgsd,bhcd->bhgsc", qg, kb)
        if causal:
            k_pos = c0 + torch.arange(kb.shape[2], device=dev)[None, :]
            logits = logits.masked_fill(~(q_pos >= k_pos), NEG_INF)
        p = torch.exp(logits - lse)                            # normalized probs
        dp = torch.einsum("bhgsd,bhcd->bhgsc", do, vb)
        ds = p * (dp - delta)
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


def _cache_rule(second: int):
    """:func:`parallel.sharding.shard_einsum`'s placements for the cache
    ``[B, T, Hkv, D]``'s on one mesh axis: rows with rows, kv heads with
    the ``[B, Hkv, ...]`` operand's heads, the sequence with the logits'
    last dim (``second``: the product over it, a partial sum)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def rule(p):
        if isinstance(p, Shard) and p.dim == 0:
            return Shard(0), p, Shard(0)
        if isinstance(p, Shard) and p.dim == 2:
            return Shard(1), p, Shard(1)
        if isinstance(p, Shard) and p.dim == 1:
            return (Replicate(), p, Shard(3)) if not second else (Shard(3), p, Partial())
        return Replicate(), Replicate(), Replicate()

    return rule


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
    own dtype), as the JAX package asks for them.
    """
    b, _, hq, d = q.shape
    _, t, hkv, _ = k_cache.shape
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    qg = (q * scale).reshape(b, hkv, g, d)
    split = splits(k_cache, 1)
    if split:
        # a DTensor cache split on its sequence stays split: each shard's
        # product over its block of the cache (DTensor's einsum merges the
        # split dim and gathers the cache)
        logits = shard_einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float(), _cache_rule(0))
    else:
        logits = torch.einsum("bhgd,bthd->bhgt", qg.float(), k_cache.float())
    logits = activation(logits, "batch", "cache_heads", None, "cache_seq")
    if cache_len is not None:
        live = torch.arange(t, device=q.device)[None] < cache_len[:, None]
        logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if split:
        out = shard_einsum("bhgt,bthd->bhgd", probs, v_cache.float(), _cache_rule(1))
    else:
        out = torch.einsum("bhgt,bthd->bhgd", probs, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)
