"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + shared attention.

38 Mamba2 layers (d_model=2048, ssm_state=64, headdim=64 -> d_inner=4096,
64 ssm heads); one SHARED transformer block (32H, d_ff=8192) invoked every
6 layers with per-invocation q-LoRA adapters; vocab=32000.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        vocab=32000,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        d_state=64,
        expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        shared_attn_every=6,
        shared_attn_lora=128,
    ).validate()
