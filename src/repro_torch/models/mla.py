"""Multi-head Latent Attention (DeepSeek-V2 [arXiv:2405.04434]; MiniCPM3).

Prefill: expand the latent KV into per-head K/V and run the flash kernel
(``chunked_attention``) with QK head dim ``qk_nope + qk_rope`` and V head
dim ``v_head_dim``: the kernel takes the two widths as they are, with no
padding of V.
Decode: *absorbed* attention — fold W_uk into the query and W_uv into the
output so attention runs directly in the kv_lora latent space, as plain
torch products (the JAX package runs no kernel there either).  The KV
cache stores only [c_kv (kv_lora) ; k_rope (qk_rope_dim)] per token.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import NEG_INF, _cache_rule, chunked_attention, query_seq_axis
from repro_torch.models.blocks import _out_proj
from repro_torch.models.common import ParamSpec, dense, rms_norm
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import (activation, shard_einsum, softmax_last, splits,
                                           write_token)

Tensor = torch.Tensor


def mla_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s: dict[str, ParamSpec] = {}
    if cfg.q_lora:
        s["wq_a"] = ParamSpec((L, d, cfg.q_lora), (None, "embed", "lora"))
        s["q_norm"] = ParamSpec((L, cfg.q_lora), (None, None), init="ones")
        s["wq_b"] = ParamSpec((L, cfg.q_lora, h, dn + dr),
                              (None, "lora", "heads", "qk"))
    else:
        s["wq"] = ParamSpec((L, d, h, dn + dr), (None, "embed", "heads", "qk"))
    s["wkv_a"] = ParamSpec((L, d, cfg.kv_lora + dr), (None, "embed", "lora"))
    s["kv_norm"] = ParamSpec((L, cfg.kv_lora), (None, None), init="ones")
    s["wkv_b"] = ParamSpec((L, cfg.kv_lora, h, dn + dv),
                           (None, "lora", "heads", "qk"))
    s["wo"] = ParamSpec((L, h, dv, d), (None, "heads", "qk", "embed"))
    return s


def _queries(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
             positions: Tensor, seq: str = "seq") -> tuple[Tensor, Tensor]:
    """-> (q_nope [B,S,H,dn], q_rope [B,S,H,dr]), the rows placed on the
    logical axis ``seq``."""
    dn = cfg.qk_nope_dim
    if cfg.q_lora:
        ql = rms_norm(dense(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = dense(ql, p["wq_b"])
    else:
        q = dense(x, p["wq"])
    q = activation(q, "batch", seq, "heads", None)
    qn, qr = q[..., :dn], q[..., dn:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _latent_kv(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
               positions: Tensor) -> tuple[Tensor, Tensor]:
    """-> (c_kv [B,S,lora] normalized, k_rope [B,S,dr] rotated)."""
    lora = cfg.kv_lora
    ckv = dense(x, p["wkv_a"])
    c_kv = rms_norm(ckv[..., :lora], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[:, :, None, lora:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_prefill(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
                positions: Tensor, kv_chunk: int = 1024) -> Tensor:
    """Full-sequence MLA via latent expansion + the flash kernel.  Where
    the attention splits its query rows over ``model`` (its kv heads are
    its heads), the projections follow, as in ``blocks.gqa_attention``:
    the queries, the latent and its expansion on row shards, the keys and
    values gathered, ``wo`` on the row shards and its output gathered."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    seq = query_seq_axis(h)
    if seq != "seq":
        x = activation(x, "batch", seq, None)
    qn, qr = _queries(p, cfg, x, positions, seq)
    c_kv, k_rope = _latent_kv(p, cfg, x, positions)
    kv = activation(dense(c_kv, p["wkv_b"]),
                    "batch", "seq", "heads", None)           # [B,S,H,dn+dv]
    if seq != "seq":
        k_rope = activation(k_rope, "batch", "seq", None)
    kn, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([kn, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    out = chunked_attention(q, k, v, causal=True, kv_chunk=kv_chunk,
                            scale=(dn + dr) ** -0.5)
    out = _out_proj(out, p["wo"], x.dtype)
    return out if seq == "seq" else activation(out, "batch", "seq", None)


def mla_decode(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
               cache: dict[str, Tensor], positions: Tensor,
               cache_len: Tensor | None = None
               ) -> tuple[Tensor, dict[str, Tensor]]:
    """Absorbed single-token decode against the latent cache.

    cache: {"c_kv": [B,T,lora], "k_rope": [B,T,dr]};  x: [B,1,d].  The
    token's latent entries are written into ``cache`` in place at
    ``cache_len`` (the last slot when it is None), where the JAX package
    returns an updated copy; the returned dict holds the same tensors.
    """
    b = x.shape[0]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    qn, qr = _queries(p, cfg, x, positions)                  # [B,1,H,dn],[B,1,H,dr]
    c_new, r_new = _latent_kv(p, cfg, x, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    t = c_kv.shape[1]
    idx = (cache_len.long() if cache_len is not None
           else torch.full((b,), t - 1, dtype=torch.long, device=x.device))
    bidx = torch.arange(b, device=x.device)
    write_token(c_kv, bidx, idx, c_new[:, 0])
    write_token(k_rope, bidx, idx, r_new[:, 0])

    w_uk = p["wkv_b"][..., :dn]                              # [lora, H, dn]
    w_uv = p["wkv_b"][..., dn:]                              # [lora, H, dv]
    q_lat = torch.einsum("bshn,lhn->bshl", qn, w_uk)          # [B,1,H,lora]
    scale = (dn + dr) ** -0.5
    split = splits(c_kv, 1)

    def product(eq, a, b_, second):
        # a latent cache split on its sequence stays split, as in
        # ``attention.decode_attention``: each shard's products over its
        # block, the softmax of the shards, the context a partial sum
        if split:
            return shard_einsum(eq, a, b_, _cache_rule(second, heads=False))
        return torch.einsum(eq, a, b_)

    logits = (product("bshl,btl->bhst", q_lat.float(), c_kv.float(), 0)
              + product("bshr,btr->bhst", qr.float(), k_rope.float(), 0)
              ) * scale                                       # [B,H,1,T]
    if cache_len is not None:
        live = torch.arange(t, device=x.device)[None] <= idx[:, None]
        logits = logits.masked_fill(~live[:, None, None], NEG_INF)
    probs = softmax_last(logits)
    ctx_lat = product("bhst,btl->bshl", probs, c_kv.float(), 1)  # [B,1,H,lora]
    out = torch.einsum("bshl,lhv->bshv", ctx_lat.to(x.dtype), w_uv)
    return _out_proj(out, p["wo"], x.dtype), {"c_kv": c_kv, "k_rope": k_rope}
