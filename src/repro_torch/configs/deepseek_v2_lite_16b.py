"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

27L d_model=2048 16H, MLA (kv_lora=512, nope 128 / rope 64 / v 128),
MoE 64 routed top-6 + 2 shared, per-expert d_ff=1408, layer 0 dense
(d_ff=10944), vocab=102400.  The assignment line reads "MoE 64e top-6" with
a "160 routed" aside; we follow the binding 64-routed reading (HF config).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        vocab=102400,
        n_heads=16,
        n_kv_heads=16,
        head_dim=192,            # qk_nope + qk_rope
        attn_kind="mla",
        q_lora=0,                # lite: direct q projection
        kv_lora=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        d_ff=10944,              # the single leading dense layer
        moe=True,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        shared_d_ff=2816,
        first_dense_layers=1,
        router_scale=True,
        rope_theta=10_000.0,
    ).validate()
