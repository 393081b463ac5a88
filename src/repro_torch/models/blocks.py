"""Transformer blocks: GQA attention (+cache decode), dense/parallel FFN.

Layout conventions: activations [B, S, d]; caches [B, T, KV, hd];
stacked layer params carry a leading L dim, and the model loops over it.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.common import ParamSpec, dense, rms_norm, swiglu
from repro_torch.models.rope import apply_mrope, apply_rope

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
    """``einsum("bshd,hdq->bsq")``: the heads flattened into one product."""
    b, s, h, hd = out.shape
    return torch.matmul(out.reshape(b, s, h * hd),
                        wo.reshape(h * hd, -1)).to(dtype)


def gqa_attention(p: dict[str, Tensor], cfg: ModelConfig, x: Tensor,
                  positions: Tensor, *, causal: bool = True,
                  kv_chunk: int = 1024, prefix: str = "") -> Tensor:
    q = dense(x, p[f"{prefix}wq"])                  # [B,S,H,hd]
    k = dense(x, p[f"{prefix}wk"])
    v = dense(x, p[f"{prefix}wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}q_norm"], cfg.norm_eps)
        k = rms_norm(k, p[f"{prefix}k_norm"], cfg.norm_eps)
    q, k = _rope_q_k(cfg, q, k, positions)
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=kv_chunk)
    return _out_proj(out, p[f"{prefix}wo"], x.dtype)


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
    kc[bidx, idx] = k[:, 0].to(kc.dtype)
    vc[bidx, idx] = v[:, 0].to(vc.dtype)
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
