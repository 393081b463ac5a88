"""Training-launcher helpers of the port: ``reduce_config`` only.

Training itself is not ported; the serving launcher shares this helper
with the JAX package's training launcher.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


def reduce_config(cfg: ModelConfig, factor: int) -> ModelConfig:
    """Scale a config down by ~factor for CPU-scale end-to-end runs."""
    if factor <= 1:
        return cfg
    def sh(x, lo=1):
        return max(x // factor, lo)
    kv = max(sh(cfg.n_kv_heads, 1), 1)
    heads = max(sh(cfg.n_heads, 1), kv)
    heads = (heads // kv) * kv or kv
    repl = dataclasses.replace(
        cfg,
        num_layers=sh(cfg.num_layers, 2),
        d_model=sh(cfg.d_model, 64),
        d_ff=sh(cfg.d_ff, 64) if cfg.d_ff else 0,
        n_heads=heads if cfg.n_heads else 0,
        n_kv_heads=kv if cfg.n_kv_heads else 0,
        head_dim=max(sh(cfg.head_dim, 16), 16) if cfg.head_dim else 0,
        vocab=max(cfg.vocab // factor, 512),
        moe_d_ff=sh(cfg.moe_d_ff, 32) if cfg.moe_d_ff else 0,
        shared_d_ff=sh(cfg.shared_d_ff, 32) if cfg.shared_d_ff else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        q_lora=sh(cfg.q_lora, 16) if cfg.q_lora else 0,
        kv_lora=sh(cfg.kv_lora, 16) if cfg.kv_lora else 0,
        qk_nope_dim=max(sh(cfg.qk_nope_dim, 8), 8) if cfg.qk_nope_dim else 0,
        qk_rope_dim=max(sh(cfg.qk_rope_dim, 8), 8) if cfg.qk_rope_dim else 0,
        v_head_dim=max(sh(cfg.v_head_dim, 8), 8) if cfg.v_head_dim else 0,
        d_state=max(sh(cfg.d_state, 16), 16) if cfg.d_state else 0,
        ssm_headdim=max(sh(cfg.ssm_headdim, 16), 16) if cfg.d_state else 64,
        ssd_chunk=64,
        enc_layers=sh(cfg.enc_layers, 1) if cfg.enc_layers else 0,
        dec_layers=sh(cfg.dec_layers, 1) if cfg.dec_layers else 0,
        shared_attn_every=cfg.shared_attn_every,
        shared_attn_lora=sh(cfg.shared_attn_lora, 8) if cfg.shared_attn_lora else 0,
        num_patches=min(cfg.num_patches, 64) if cfg.num_patches else 0,
        mrope_sections=(
            tuple(int(x) for x in _scale_sections(cfg, factor))
            if cfg.mrope else cfg.mrope_sections),
    )
    return repl.validate()


def _scale_sections(cfg: ModelConfig, factor: int):
    hd = max(cfg.head_dim // factor, 16)
    half = hd // 2
    t = max(half // 4, 1)
    rest = half - t
    h = rest // 2
    w = rest - h
    return (t, h, w)
