"""Seamless-M4T medium backbone [arXiv:2308.11596] — enc-dec.

12L encoder + 12L decoder, d_model=1024 16H (kv=16) d_ff=4096
vocab=256206.  The modality frontend is a STUB: input_specs() supplies
precomputed frame embeddings (assignment rule).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=24,
        d_model=1024,
        vocab=256206,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        enc_layers=12,
        dec_layers=12,
        num_frames=512,
    ).validate()
