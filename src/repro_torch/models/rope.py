"""Rotary position embeddings: standard and partial (StableLM).

M-RoPE (Qwen2-VL) waits for the VLM family.
"""

from __future__ import annotations

import functools

import torch

Tensor = torch.Tensor


def rope_freqs(dim: int, theta: float) -> Tensor:
    """[dim/2] inverse frequencies, f32, computed on the host."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    return 1.0 / (theta ** exps)


@functools.lru_cache(maxsize=32)
def _freqs_on(dim: int, theta: float, device: torch.device) -> Tensor:
    """:func:`rope_freqs` copied to ``device``, built once per device.

    Every device rotates with bitwise the same frequencies (a card's own
    ``pow`` may differ from the host's by an ulp, and at position p an ulp
    of frequency turns the angle by p ulps), and a call launches no
    kernels to rebuild them.
    """
    return rope_freqs(dim, theta).to(device)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               fraction: float = 1.0) -> Tensor:
    """Rotate the first ``fraction`` of the head dim.

    x: [B, S, H, D]; positions: [B, S] int32.
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = _freqs_on(rot, float(theta), x.device)               # [rot/2]
    ang = positions.float()[..., None] * inv                   # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)
