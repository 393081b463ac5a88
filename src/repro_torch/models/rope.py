"""Rotary position embeddings: standard, partial (StableLM) and M-RoPE
(Qwen2-VL: separate temporal/height/width sections of the head dim)."""

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
    kernels to rebuild them.  The copy is made on the CPU too, so building
    the table is the same ops on every device (``analysis.cost``).
    """
    return rope_freqs(dim, theta).to(device, copy=True)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               fraction: float = 1.0) -> Tensor:
    """Rotate the first ``fraction`` of the head dim.

    x: [B, S, H, D]; positions: [B, S] int32.  Positions alike in every
    row (a ``[1, S]`` row expanded: the default ``arange``) build one row's
    table, broadcast over the batch.
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    if positions.stride(0) == 0:
        positions = positions[:1]
    inv = _freqs_on(rot, float(theta), x.device)               # [rot/2]
    ang = positions.float()[..., None] * inv                   # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


@functools.lru_cache(maxsize=32)
def _section_ids(sections: tuple[int, int, int], device: torch.device) -> Tensor:
    """[half] the position stream (0 t, 1 h, 2 w) of each rotary frequency,
    built on the host and copied to ``device`` once."""
    return torch.repeat_interleave(torch.arange(3), torch.tensor(sections)).to(
        device, copy=True)


def clear_tables() -> None:
    """Drop the per-device frequency and section tables: the next call
    builds them again (``analysis.cost.trace_cost`` counts them so)."""
    _freqs_on.cache_clear()
    _section_ids.cache_clear()


def apply_mrope(x: Tensor, positions: Tensor, theta: float,
                sections: tuple[int, int, int]) -> Tensor:
    """Multimodal RoPE (Qwen2-VL).

    x: [B, S, H, D]; positions: [3, B, S] — temporal/height/width position
    ids.  The rotary half-dim is partitioned into ``sections`` (t, h, w);
    each section's angles use the corresponding position stream.
    """
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    inv = _freqs_on(d, float(theta), x.device)                 # [half]
    sec_ids = _section_ids(tuple(sections), x.device)          # [half]
    pos_sel = positions.float()[sec_ids]                       # [half, B, S]
    ang = torch.einsum("fbs,f->bsf", pos_sel, inv)             # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
