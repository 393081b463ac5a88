"""Command-R+-class 104B dense [hf:CohereForAI; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, parallel
attention+FFN block, no biases.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        vocab=256000,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        parallel_block=True,
        rope_theta=75_000_000.0,
    ).validate()
