"""Architecture registry of the port: ``--arch <id>`` -> ``ModelConfig``.

Only the architectures the port runs are listed.  The JAX package's other
ids raise ``KeyError`` naming them as not yet ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "mamba2-370m": "mamba2_370m",
    "zamba2-1.2b": "zamba2_1_2b",
}

#: architectures of the JAX package that the port does not run yet
NOT_PORTED = (
    "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "stablelm-3b", "minicpm3-4b",
    "command-r-plus-104b", "seamless-m4t-medium", "qwen2-vl-7b",
)


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet; the port runs "
                       f"{sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config()

