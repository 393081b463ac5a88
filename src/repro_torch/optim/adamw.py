"""AdamW (decoupled weight decay) + cosine schedule + global-norm clipping.

Port of ``repro.optim.adamw``: plain functions on tensor trees, step for
step the JAX package's update (``torch.optim`` is not used, so the order
of operations and the rounding are the same).  The arithmetic is float32
and each new parameter is cast back to its own dtype; the moments are
``moment_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import flatten, leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: Tensor     # 0-d int32
    mu: Any          # first moments  (tree like params)
    nu: Any          # second moments


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    """Zero moments beside each parameter (on its device), step 0."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def schedule(step: Tensor, cfg: AdamWConfig) -> Tensor:
    """Learning rate at ``step`` (float32): linear warmup, then cosine decay
    to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any) -> Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: OptState,
                  cfg: AdamWConfig) -> tuple[Any, OptState, dict[str, Tensor]]:
    """One AdamW step.  Returns (params', state', metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(step, cfg)
    sf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device), sf)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return new_p, m.to(mdt), v.to(mdt)

    flat_p, unflatten = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, leaves(grads), leaves(state.mu), leaves(state.nu))]
    new_p = unflatten([o[0] for o in out])
    new_m = unflatten([o[1] for o in out])
    new_v = unflatten([o[2] for o in out])
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
