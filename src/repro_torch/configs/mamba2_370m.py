"""Mamba2-370M [arXiv:2405.21060] — attention-free SSD.

48L d_model=1024, ssm_state=128, headdim=64 -> d_inner=2048 (32 heads),
vocab=50280, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        attn_kind="none",
        num_layers=48,
        d_model=1024,
        vocab=50280,
        d_state=128,
        expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        tie_embeddings=True,
    ).validate()
