"""Architecture registry of the port: ``--arch <id>`` -> ``ModelConfig``.

The JAX package's ten architectures, in its order.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "stablelm-3b": "stablelm_3b",
    "minicpm3-4b": "minicpm3_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "smollm-360m": "smollm_360m",
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

#: archs whose sequence handling is sub-quadratic (run long_500k)
SUBQUADRATIC = {"mamba2-370m", "zamba2-1.2b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config()


def all_archs() -> list[str]:
    return list(ARCHS)
