"""Assigned input shapes and per-(arch x shape) step inputs (port of
``repro.launch.shapes``).

Every model input (the parameter tree and decode state too, through
``models.common.abstract_params``) comes as ``meta`` tensors, so the
dry-run traces a full-size step without allocating.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import SUBQUADRATIC
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("pure full-attention arch: 500k-context decode is a "
                       "quadratic-regime artifact; skipped per assignment "
                       "(DESIGN.md §6)")
    return True, ""


def _frames_for(cfg: ModelConfig, seq: int) -> int:
    """Stub audio frontend: ~4x temporal downsampling of the target length."""
    return max(min(seq // 4, 4096), 64)


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, tuple]:
    """Logical axes per input tensor (for shardings)."""
    if shape.kind in ("train", "prefill"):
        ax: dict[str, tuple] = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            ax["labels"] = ("batch", "seq")
        if cfg.family == "vlm":
            ax["vision_embeds"] = ("batch", "patches", None)
            ax["vision_pos"] = ("batch", "patches")
            ax["positions"] = (None, "batch", "seq")
        if cfg.family == "encdec":
            ax["frames"] = ("batch", "frames", None)
        return ax
    ax = {"token": ("batch", None), "cache_len": ("batch",)}
    if cfg.mrope:
        ax["positions"] = (None, "batch", None)
    return ax


def input_structs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, torch.Tensor]:
    """``meta`` tensors of the step's ``batch`` argument."""
    b, s = shape.batch, shape.seq
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        out: dict[str, Any] = {"tokens": meta((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = meta((b, s), i32)
        if cfg.family == "vlm":
            p = cfg.num_patches
            out["vision_embeds"] = meta((b, p, cfg.d_model), dt)
            out["vision_pos"] = meta((b, p), i32)
            out["positions"] = meta((3, b, s), i32)
        if cfg.family == "encdec":
            out["frames"] = meta((b, _frames_for(cfg, s), cfg.d_model), dt)
        return out
    out = {"token": meta((b, 1), i32), "cache_len": meta((b,), i32)}
    if cfg.mrope:
        out["positions"] = meta((3, b, 1), i32)
    return out


def concrete_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                    device: "str | torch.device" = "cuda") -> dict[str, torch.Tensor]:
    """A concrete batch of :func:`input_structs`' shapes on ``device`` (for
    smoke runs on reduced configs).  As in the JAX package: ``cache_len``
    at ``seq // 2``, ``vision_pos`` ``arange(P)`` in each row, the other
    int32 fields zero and the floats 0.02; the token fields (tokens,
    labels, token) are drawn in ``[0, min(vocab, 1000))`` from a CPU
    ``torch.Generator`` seeded with ``seed`` anew for each (so tokens and
    labels agree, as one JAX key gives both), not from ``jax.random``."""
    dev = resolve_device(device)
    out = {}
    for k, v in input_structs(cfg, shape).items():
        if v.dtype == torch.int32:
            if k == "cache_len":
                x = torch.full(v.shape, shape.seq // 2, dtype=torch.int32)
            elif k in ("tokens", "labels", "token"):
                gen = torch.Generator().manual_seed(seed)
                x = torch.randint(0, min(cfg.vocab, 1000), v.shape, generator=gen,
                                  dtype=torch.int32)
            elif k == "vision_pos":
                x = torch.arange(v.shape[1], dtype=torch.int32)[None].expand(v.shape)
            else:
                x = torch.zeros(v.shape, dtype=torch.int32)
            out[k] = x.to(dev)
        else:
            out[k] = torch.ones(v.shape, dtype=v.dtype, device=dev) * 0.02
    return out
