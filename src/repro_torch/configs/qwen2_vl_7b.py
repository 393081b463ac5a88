"""Qwen2-VL-7B backbone [arXiv:2409.12191] — M-RoPE decoder.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Vision frontend
is a STUB: input_specs() supplies precomputed patch embeddings; M-RoPE
(t/h/w sections 16/24/24 of the rotary half-dim) positions are inputs.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        vocab=152064,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        mrope=True,
        mrope_sections=(16, 24, 24),
        num_patches=1024,
        rope_theta=1_000_000.0,
    ).validate()
