"""StableLM-3B-class dense model [hf:stabilityai/stablelm-2; unverified].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304, partial rotary 25%.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        num_layers=32,
        d_model=2560,
        vocab=50304,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        rope_fraction=0.25,
    ).validate()
