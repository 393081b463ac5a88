"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared hidden 4x1408=5632).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        vocab=151936,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=5632,
        moe=True,
        n_experts=60,
        n_shared_experts=4,
        top_k=4,
        moe_d_ff=1408,
        shared_d_ff=5632,
        rope_theta=1_000_000.0,
    ).validate()
