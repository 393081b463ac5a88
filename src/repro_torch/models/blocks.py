"""Transformer blocks: GQA attention (+cache decode), dense/parallel FFN.

Layout conventions: activations [B, S, d]; caches [B, T, KV, hd];
stacked layer params carry a leading L dim, and the model loops over it.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import chunked_attention, decode_attention, query_seq_axis
from repro_torch.models.common import ParamSpec, dense, rms_norm, swiglu
from repro_torch.models.rope import apply_mrope, apply_rope
from repro_torch.parallel.sharding import activation, matmul, merge, unsplit, write_token

Tensor = torch.Tensor


def attn_specs(cfg: ModelConfig, L: int, prefix: str = "") -> dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        f"{prefix}wq": ParamSpec((L, d, h, hd), (None, "embed", "heads", "qk")),
        f"{prefix}wk": ParamSpec((L, d, kv, hd), (None, "embed", "kv_heads", "qk")),
        f"{prefix}wv": ParamSpec((L, d, kv, hd), (None, "embed", "kv_heads", "qk")),
        f"{prefix}wo": ParamSpec((L, h, hd, d), (None, "heads", "qk", "embed")),
    }
    if cfg.qk_norm:
        s[f"{prefix}q_norm"] = ParamSpec((L, hd), (None, None), init="ones")
        s[f"{prefix}k_norm"] = ParamSpec((L, hd), (None, None), init="ones")
    return s


def ffn_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((L, d, f), (None, "embed", "ff")),
        "w_up": ParamSpec((L, d, f), (None, "embed", "ff")),
        "w_down": ParamSpec((L, f, d), (None, "ff", "embed")),
    }


def block_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    s = {"ln1": ParamSpec((L, d), (None, None), init="ones")}
    s.update(attn_specs(cfg, L))
    if not cfg.parallel_block:
        s["ln2"] = ParamSpec((L, d), (None, None), init="ones")
    s.update(ffn_specs(cfg, L))
    return s


def _rope_q_k(cfg: ModelConfig, q: Tensor, k: Tensor, positions: Tensor
              ) -> tuple[Tensor, Tensor]:
    if cfg.mrope:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction),
            apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction))


def _out_proj(out: Tensor, wo: Tensor, dtype: torch.dtype) -> Tensor:
    """``einsum("bshd,hdq->bsq")``: the heads flattened into one product.
    A DTensor ``out`` split on heads a mesh axis does not divide has them
    gathered first (``unsplit``): no shard can flatten an uneven split."""
    b, s, h, hd = out.shape
    return matmul(merge(unsplit(out, 2, h), (b, s, h * hd), 2),
                  merge(wo, (h * hd, -1), 0)).to(dtype)


def gqa_attention(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
                  positions: Tensor, *, causal: bool = True,
                  kv_chunk: int = 1024, prefix: str = "") -> Tensor:
    """Full-sequence GQA attention, ``[B, S, d]``.  Where the attention
    splits its query rows over ``model`` (``attention.query_seq_axis``),
    the projections follow, as XLA's do: q, k and v are computed on row
    shards, k and v gathered for the flash call, ``wo`` applied on the
    row shards and its output gathered."""
    seq = query_seq_axis(cfg.n_kv_heads)
    if seq != "seq":
        x = activation(x, "batch", seq, None)
    q = activation(dense(x, p[f"{prefix}wq"]),
                   "batch", seq, "heads", None)     # [B,S,H,hd]
    k = activation(dense(x, p[f"{prefix}wk"]),
                   "batch", "seq", "kv_heads", None)
    v = activation(dense(x, p[f"{prefix}wv"]),
                   "batch", "seq", "kv_heads", None)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}q_norm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}k_norm"], cfg.norm_eps)
    q, k = _rope_q_k(cfg, q, k, positions)
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
    out = _out_proj(out, p[f"{prefix}wo"], x.dtype)
    return out if seq == "seq" else activation(out, "batch", "seq", None)


def gqa_decode(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
               cache: dict[str, Tensor], positions: Tensor,
               cache_len: Tensor | None, prefix: str = ""
               ) -> tuple[Tensor, dict[str, Tensor]]:
    """Single-token attention with cache insert.  x [B,1,d].

    The new key and value are written into ``cache`` in place at
    ``cache_len`` (the last slot when it is None), where the JAX package
    returns an updated copy: a step then moves one token's K/V, not the
    whole cache.  The returned dict holds the same tensors.
    """
    b = x.shape[0]
    q = dense(x, p[f"{prefix}wq"])
    k = dense(x, p[f"{prefix}wk"])
    v = dense(x, p[f"{prefix}wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}q_norm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}k_norm"], cfg.norm_eps)
    q, k = _rope_q_k(cfg, q, k, positions)
    kc, vc = cache["k"], cache["v"]
    t = kc.shape[1]
    idx = (cache_len.long() if cache_len is not None
           else torch.full((b,), t - 1, dtype=torch.long, device=x.device))
    bidx = torch.arange(b, device=x.device)
    write_token(kc, bidx, idx, k[:, 0])
    write_token(vc, bidx, idx, v[:, 0])
    out = decode_attention(q, kc, vc,
                           cache_len=idx + 1 if cache_len is not None else None)
    return _out_proj(out, p[f"{prefix}wo"], x.dtype), {"k": kc, "v": vc}


def dense_ffn(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor) -> Tensor:
    if cfg.ffn_act == "swiglu":
        h = swiglu(dense(x, p["w_gate"]), dense(x, p["w_up"]))
    else:
        h = torch.nn.functional.gelu(dense(x, p["w_up"]), approximate="tanh")
    return dense(h, p["w_down"])


def init_attn_cache(cfg: ModelConfig, batch: int, seq: int, dtype: torch.dtype,
                    layers: int | None = None,
                    device: "str | torch.device" = "cuda") -> dict[str, Tensor]:
    """Zero K/V caches ``[B, T, KV, hd]`` (``[layers, B, T, KV, hd]`` with
    ``layers``) on ``device``; ``"meta"`` allocates nothing."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, seq, kv, hd)
    if layers is not None:
        shape = (layers,) + shape
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}
