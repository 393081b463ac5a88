"""Encoder-decoder backbone (Seamless-M4T medium, [arXiv:2308.11596]).

The modality frontend (speech encoder frontend / text tokenizer) is a STUB:
callers supply precomputed frame embeddings [B, F, d], as in the JAX
package; only the transformer backbone is modeled.  The encoder is
bidirectional; the decoder is causal with cross-attention to the
encoder's frames (non-causal, ``S`` queries against ``F`` keys).  RoPE
replaces Seamless' relative position bias, as in the JAX package.  Every
attention of a prefill runs the flash kernel; decode reads the self
cache and the fixed cross K/V with plain products.  ``encdec_loss`` is
the training loss: encoder, teacher-forced decoder, then the seq-chunked
cross entropy of ``lm.chunked_ce``; gradients reach the flash kernel's
three attentions through ``FlashAttention``.  Each entry takes the JAX
package's ``ctx`` in its position and binds it with ``use_ctx`` for the
call (``None``: the ambient context).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.blocks import _out_proj, attn_specs, dense_ffn, ffn_specs, gqa_decode
from repro_torch.models.common import ParamSpec, dense, rms_norm
from repro_torch.models.lm import KV_CHUNK, _layer, _layers, _remat, chunked_ce
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import ShardingCtx, activation, embed_lookup, use_ctx

Tensor = torch.Tensor


def encdec_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    enc: dict[str, ParamSpec] = {
        "ln1": ParamSpec((cfg.enc_layers, d), (None, None), init="ones"),
        "ln2": ParamSpec((cfg.enc_layers, d), (None, None), init="ones"),
    }
    enc.update(attn_specs(cfg, cfg.enc_layers))
    enc.update(ffn_specs(cfg, cfg.enc_layers))

    dec: dict[str, ParamSpec] = {
        "ln1": ParamSpec((cfg.dec_layers, d), (None, None), init="ones"),
        "ln_x": ParamSpec((cfg.dec_layers, d), (None, None), init="ones"),
        "ln2": ParamSpec((cfg.dec_layers, d), (None, None), init="ones"),
    }
    dec.update(attn_specs(cfg, cfg.dec_layers))
    dec.update(attn_specs(cfg, cfg.dec_layers, prefix="x_"))
    dec.update(ffn_specs(cfg, cfg.dec_layers))

    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed",
                           scale=0.02),
        "enc_norm": ParamSpec((d,), (None,), init="ones"),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "unembed": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
        "encoder": enc,
        "decoder": dec,
    }


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _self_attn(cfg: ModelConfig, p, x, positions, causal, prefix=""):
    q = dense(x, p[f"{prefix}wq"])
    k = dense(x, p[f"{prefix}wk"])
    v = dense(x, p[f"{prefix}wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q, k, v, causal=causal, kv_chunk=KV_CHUNK)
    return _out_proj(out, p[f"{prefix}wo"], x.dtype)


def _cross_attn(cfg: ModelConfig, p, x, enc_out):
    q = dense(x, p["x_wq"])
    k = dense(enc_out, p["x_wk"])
    v = dense(enc_out, p["x_wv"])
    out = chunked_attention(q, k, v, causal=False, kv_chunk=KV_CHUNK)
    return _out_proj(out, p["x_wo"], x.dtype)


def encode(cfg: ModelConfig, params, frames: Tensor,
           ctx: ShardingCtx | None = None) -> Tensor:
    """frames [B, F, d] (stub frontend embeddings) -> [B, F, d]."""
    with use_ctx(ctx):
        return _encode(cfg, params, frames)


def _encode(cfg: ModelConfig, params, frames: Tensor) -> Tensor:
    b, f, _ = frames.shape
    positions = _positions(b, f, frames.device)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _self_attn(cfg, lp, h, positions, causal=False)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + dense_ffn(lp, cfg, h2)

    body = _remat(body, cfg)
    x = frames
    for lp in _layers(params["encoder"]):
        x = body(x, lp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(cfg: ModelConfig, params, tokens: Tensor, enc_out: Tensor,
                 ctx: ShardingCtx | None = None) -> Tensor:
    """Teacher-forced decoder.  tokens [B, S] -> hidden [B, S, d]."""
    with use_ctx(ctx):
        return _decode_train(cfg, params, tokens, enc_out)


def _decode_train(cfg: ModelConfig, params, tokens: Tensor, enc_out: Tensor
                  ) -> Tensor:
    b, s = tokens.shape
    # placed as ``lm.embed_tokens`` places its rows, not left to how a
    # torch version's DTensor propagates a column-split lookup
    x = activation(embed_lookup(params["embed"], tokens), "batch", "seq", None)
    positions = _positions(b, s, x.device)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _self_attn(cfg, lp, h, positions, causal=True)
        hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        x = x + _cross_attn(cfg, lp, hx, enc_out)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + dense_ffn(lp, cfg, h2)

    body = _remat(body, cfg)
    for lp in _layers(params["decoder"]):
        x = body(x, lp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def encdec_loss(cfg: ModelConfig, params, batch, ctx: ShardingCtx | None = None
                ) -> tuple[Tensor, dict[str, Tensor]]:
    """``(loss, {"ce", "moe_aux", "tokens"})`` of a batch with ``frames``
    [B, F, d], ``tokens`` and ``labels`` [B, S]: the mean NLL of the
    decoder's logits (``params["unembed"]``) over the non-ignored labels,
    ``moe_aux`` a float32 zero (no MoE layer), as the JAX package's."""
    enc_out = encode(cfg, params, batch["frames"], ctx)
    x = decode_train(cfg, params, batch["tokens"], enc_out, ctx)
    loss, tok = chunked_ce(cfg, x, params["unembed"], batch["labels"])
    return loss, {"ce": loss,
                  "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device),
                  "tokens": tok}


def encdec_state_specs(cfg: ModelConfig, batch: int, seq: int
                       ) -> dict[str, Any]:
    """Self-attn cache + precomputed cross K/V (encoder ran at prefill)."""
    kv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.dec_layers
    f = cfg.num_frames
    c = ("batch", "cache_seq", "cache_heads", None)
    return {
        "self": {
            "k": ParamSpec((L, batch, seq, kv, hd), (None,) + c, init="zeros"),
            "v": ParamSpec((L, batch, seq, kv, hd), (None,) + c, init="zeros"),
        },
        "cross": {
            "k": ParamSpec((L, batch, f, kv, hd),
                           (None, "batch", None, "cache_heads", None),
                           init="zeros"),
            "v": ParamSpec((L, batch, f, kv, hd),
                           (None, "batch", None, "cache_heads", None),
                           init="zeros"),
        },
    }


def cross_kv(cfg: ModelConfig, params, enc_out: Tensor) -> dict[str, Tensor]:
    """The decoder's cross K/V of ``enc_out`` [B, F, d]: ``{"k", "v"}``
    ``[L, B, F, Hkv, hd]``, the serve state's ``"cross"`` (unrotated, as
    ``_cross_attn`` uses them)."""
    dec = params["decoder"]
    return {n: torch.stack([dense(enc_out, w) for w in dec[f"x_w{n}"].unbind(0)])
            for n in ("k", "v")}


def encdec_decode_step(cfg: ModelConfig, params, state, batch,
                       ctx: ShardingCtx | None = None
                       ) -> tuple[Tensor, dict[str, Any]]:
    """One decoder token against self cache + fixed cross K/V.

    The self cache is written in place (see ``gqa_decode``); the returned
    state holds the same tensors.
    """
    with use_ctx(ctx):
        return _encdec_decode_step(cfg, params, state, batch)


def _encdec_decode_step(cfg: ModelConfig, params, state, batch
                        ) -> tuple[Tensor, dict[str, Any]]:
    x = activation(embed_lookup(params["embed"], batch["token"]),
                   "batch", None, None)                  # [B,1,d], reduced once
    cache_len = batch.get("cache_len")
    positions = (batch.get("positions") if batch.get("positions") is not None
                 else cache_len[:, None])
    dec = params["decoder"]
    for i, lp in enumerate(_layers(dec)):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        attn, _ = gqa_decode(lp, cfg, h, _layer(state["self"], i), positions,
                             cache_len)
        x = x + attn
        hx = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = dense(hx, lp["x_wq"])
        out = decode_attention(q, state["cross"]["k"][i], state["cross"]["v"][i])
        x = x + _out_proj(out, lp["x_wo"], x.dtype)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + dense_ffn(lp, cfg, h2)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0], params["unembed"])
    return logits, state
