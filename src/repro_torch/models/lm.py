"""Decoder-only LM over ModelConfig: the dense family.

Single source of truth per architecture, as in the JAX package:
  model_specs(cfg)        -> ParamSpec tree (init, weight conversion)
  forward(cfg, p, batch)  -> [B, S, vocab] logits
  decode_state_specs(cfg) -> KV-cache ParamSpec tree
  decode_step(...)        -> one-token serve step over the cache

The JAX package scans the stacked ``[L, ...]`` layer parameters; here the
model loops over ``L``.  Its ``remat`` policy and its ``ShardingCtx`` /
``activation`` constraints concern training and meshes and have no
meaning for inference on one card, so they are left out.  The MoE, SSM,
hybrid, VLM and enc-dec families raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import block_specs, dense_ffn, gqa_attention, gqa_decode
from repro_torch.models.common import ParamSpec, dense, rms_norm, spec_param_count

Tensor = torch.Tensor

KV_CHUNK = 1024           # KV block of the chunked (cache-length) attention


def _dense_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        fam = cfg.family if cfg.family != "dense" else f"dense/{cfg.attn_kind}"
        raise NotImplementedError(
            f"{what}: family {fam!r} is not ported yet (the port runs the "
            "dense GQA family)")


# -- specs -----------------------------------------------------------------


def model_specs(cfg: ModelConfig) -> dict[str, Any]:
    _dense_only(cfg, "model_specs")
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed",
                           scale=0.02),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"),
                                     scale=1.0)
    specs["layers"] = block_specs(cfg, cfg.num_layers)
    return specs


def _layer(stacked: dict[str, Tensor], i: int) -> dict[str, Tensor]:
    return {k: t[i] for k, t in stacked.items()}


# -- forward ------------------------------------------------------------------


def _block_forward(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor,
                   positions: Tensor) -> Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn = gqa_attention(p, cfg, h, positions, kv_chunk=KV_CHUNK)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h)
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + dense_ffn(p, cfg, h2)


def embed_tokens(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    x = params["embed"][batch["tokens"]]
    if cfg.tie_embeddings:
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def backbone(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Token embed -> blocks -> final norm: hidden [B, S, d].

    (The JAX package also returns the MoE aux loss, zero for this family.)
    """
    _dense_only(cfg, "backbone")
    x = embed_tokens(cfg, params, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    layers = params["layers"]
    for i in range(layers["ln1"].shape[0]):
        x = _block_forward(cfg, _layer(layers, i), x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed_matrix(cfg: ModelConfig, params: dict[str, Any]) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Full logits [B, S, vocab]."""
    x = backbone(cfg, params, batch)
    return dense(x, _unembed_matrix(cfg, params))


# -- decode ---------------------------------------------------------------------


def decode_state_specs(cfg: ModelConfig, batch: int, seq: int
                       ) -> dict[str, Any]:
    """KV-cache ParamSpec tree for serve_step: ``[L, B, T, Hkv, hd]`` k and v."""
    _dense_only(cfg, "decode_state_specs")
    shp = (cfg.num_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    axes = (None, "batch", "cache_seq", "cache_heads", None)
    return {"layers": {"k": ParamSpec(shp, axes, init="zeros"),
                       "v": ParamSpec(shp, axes, init="zeros")}}


def _block_decode(cfg: ModelConfig, p, x, cache, positions, cache_len):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn, cache = gqa_decode(p, cfg, h, cache, positions, cache_len)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h), cache
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + dense_ffn(p, cfg, h2), cache


def decode_step(cfg: ModelConfig, params: dict[str, Any],
                state: dict[str, Any], batch) -> tuple[Tensor, dict[str, Any]]:
    """One-token decode.  batch: {"token": [B,1], "cache_len": [B],
    "positions": [B,1]}.  Returns (logits [B, vocab], state).

    The token is embedded without the tied-embedding scale that
    :func:`embed_tokens` applies, as the JAX package's ``decode_step`` does.
    The caches in ``state`` are updated in place (see ``gqa_decode``) and
    the returned state holds the same tensors.
    """
    _dense_only(cfg, "decode_step")
    x = params["embed"][batch["token"]]                    # [B,1,d]
    positions = batch.get("positions")
    if positions is None:
        positions = batch["cache_len"][:, None]
    cache_len = batch.get("cache_len")
    layers, caches = params["layers"], state["layers"]
    for i in range(layers["ln1"].shape[0]):
        x, _ = _block_decode(cfg, _layer(layers, i), x, _layer(caches, i),
                             positions, cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0], _unembed_matrix(cfg, params))
    return logits, {"layers": caches}


# -- param counting ---------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameters of the model (dense: every parameter is active)."""
    return spec_param_count(model_specs(cfg))
