"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M] — llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        vocab=49152,
        n_heads=15,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        tie_embeddings=True,
    ).validate()
