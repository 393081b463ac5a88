"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — deep-thin MLA dense model.

62L d_model=2560 40H MLA (q_lora=768, kv_lora=256, nope 64 / rope 32 /
v 64) d_ff=6400 vocab=73448.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        num_layers=62,
        d_model=2560,
        vocab=73448,
        n_heads=40,
        n_kv_heads=40,
        head_dim=96,             # qk_nope + qk_rope
        attn_kind="mla",
        q_lora=768,
        kv_lora=256,
        qk_nope_dim=64,
        qk_rope_dim=32,
        v_head_dim=64,
        d_ff=6400,
    ).validate()
