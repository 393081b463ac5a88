"""Mixture-of-Experts FFN (Qwen1.5-MoE, DeepSeek-V2): capacity-based
scatter dispatch, as in the JAX package.

Each token is routed to its top-k experts; the tokens of an expert fill a
buffer of ``capacity`` rows in token order, later ones past it are
dropped; the expert FFN runs as one batched product over ``[E, cap, d]``
(a library GEMM, which the JAX package also leaves to XLA), and each
token sums its experts' outputs weighted by their gates.

Two orders are pinned to the JAX package's:

- **ties among router probabilities**: ``jax.lax.top_k`` puts the lower
  expert index first among equal values, and ``torch.topk`` promises no
  order; :func:`route` takes the top k of a stable descending sort.  The
  order sets both the experts and the slot order, which sets capacity
  positions;
- **dispatch**: kept tokens land in distinct buffer rows (positions are
  unique), so they are written by index (``index_copy_``), dropped ones
  into one spare row that is cut off: no accumulation, no float atomics.

The JAX package's expert-parallel ``shard_map`` branch (experts sharded
over a mesh's ``model`` axis) is not ported: :func:`moe_ffn` takes no
mesh, and passing one raises ``TypeError``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, dense, swiglu

Tensor = torch.Tensor

#: experts are padded so every supported model-axis size divides the count
EXPERT_PAD_TO = 16


def padded_experts(cfg: ModelConfig) -> int:
    return math.ceil(cfg.n_experts / EXPERT_PAD_TO) * EXPERT_PAD_TO


def moe_specs(cfg: ModelConfig, L: int) -> dict[str, ParamSpec]:
    d = cfg.d_model
    e = padded_experts(cfg)
    f = cfg.moe_d_ff
    s = {
        "router": ParamSpec((L, d, cfg.n_experts), (None, "embed", None),
                            scale=0.1),
        "w_gate": ParamSpec((L, e, d, f), (None, "experts", "embed", "moe_ff")),
        "w_up": ParamSpec((L, e, d, f), (None, "experts", "embed", "moe_ff")),
        "w_down": ParamSpec((L, e, f, d), (None, "experts", "moe_ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff
        s["ws_gate"] = ParamSpec((L, d, fs), (None, "embed", "ff"))
        s["ws_up"] = ParamSpec((L, d, fs), (None, "embed", "ff"))
        s["ws_down"] = ParamSpec((L, fs, d), (None, "ff", "embed"))
    return s


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    e = padded_experts(cfg)
    c = math.ceil(tokens * cfg.top_k * cfg.capacity_factor / e)
    return max(8, math.ceil(c / 8) * 8)


def route(x: Tensor, router: Tensor, cfg: ModelConfig, e_pad: int
          ) -> tuple[Tensor, Tensor, Tensor]:
    """``(probs [T, e_pad] f32, gates [T, k] f32, ids [T, k] int64)``: the
    router's softmax over the real experts (pad experts at -1e30), its top
    k in descending order, lower index first among ties, and their gates
    (normalized over the k with ``router_scale``)."""
    logits = dense(x, router).float()                        # [T, E_real]
    if e_pad > cfg.n_experts:                                # mask pad experts
        logits = torch.nn.functional.pad(logits, (0, e_pad - cfg.n_experts),
                                         value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = srt[:, :cfg.top_k], order[:, :cfg.top_k]
    if cfg.router_scale:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, ids


def dispatch(ids: Tensor, el: int, e0: int, cap: int) -> tuple[Tensor, Tensor]:
    """``(keep [T, k] bool, slot_idx [T, k] int64)``: each (token, slot)'s
    row ``local expert * cap + position`` in the dispatch buffer of the
    ``el`` experts from ``e0`` on, slot by slot and in token order within
    a slot; a token whose expert is not owned or already holds ``cap``
    tokens is dropped (``keep`` False, row ``el * cap``)."""
    counts = torch.zeros((el,), dtype=torch.long, device=ids.device)
    keeps, slots = [], []
    for eid in ids.unbind(1):
        lid = eid - e0                                        # local expert id
        own = (lid >= 0) & (lid < el)
        oh = torch.nn.functional.one_hot(lid.clamp(0, el - 1), el) * own[:, None]
        pos = counts[None, :] + torch.cumsum(oh, dim=0) - oh  # pre-increment
        pos = torch.sum(pos * oh, dim=1)                      # [T]
        counts = counts + oh.sum(dim=0)
        keep = own & (pos < cap)
        keeps.append(keep)
        slots.append(torch.where(keep, lid * cap + pos, el * cap))
    return torch.stack(keeps, dim=1), torch.stack(slots, dim=1)


def _moe_local(
    x: Tensor,            # [Tl, d]  this shard's tokens
    router: Tensor,       # [d, E_real]
    w_gate: Tensor,       # [El, d, f]   this shard's experts
    w_up: Tensor,
    w_down: Tensor,       # [El, f, d]
    *,
    cfg: ModelConfig,
    e0: int,              # first owned expert id
    n_shards: int,
) -> tuple[Tensor, Tensor]:
    """Shard-local capacity routing + expert FFN.  Returns (y, aux_loss)."""
    tl, d = x.shape
    el = w_gate.shape[0]
    e_pad = el * n_shards
    cap = _capacity(tl, cfg)
    probs, gates, ids = route(x, router, cfg, e_pad)

    # Switch-style load-balance auxiliary loss (over real experts)
    experts = torch.arange(e_pad, device=x.device)
    density = (ids[..., None] == experts).any(dim=1).float().mean(dim=0)  # [E]
    aux = torch.sum(density * probs.mean(dim=0)) * cfg.n_experts

    # dispatch: tokens -> [El, cap, d] buffers for owned experts, plus one
    # spare row (index el * cap) that takes every dropped token
    keep, slot_idx = dispatch(ids, el, e0, cap)
    buf = torch.zeros((el * cap + 1, d), dtype=x.dtype, device=x.device)
    for rows in slot_idx.unbind(1):
        buf.index_copy_(0, rows, x)
    eb = buf[:el * cap].reshape(el, cap, d)
    h = swiglu(torch.bmm(eb, w_gate), torch.bmm(eb, w_up))
    out = torch.bmm(h.to(x.dtype), w_down).reshape(el * cap, d)

    y = torch.zeros_like(x)
    g = (gates * keep).to(x.dtype)
    for slot in range(cfg.top_k):
        y = y + g[:, slot, None] * out[slot_idx[:, slot].clamp(max=el * cap - 1)]
    return y, aux


def moe_ffn(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor
            ) -> tuple[Tensor, Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux scalar), all experts on one device
    (the JAX package's mesh-less branch)."""
    b, s, d = x.shape
    yflat, aux = _moe_local(x.reshape(b * s, d), p["router"], p["w_gate"],
                            p["w_up"], p["w_down"], cfg=cfg, e0=0, n_shards=1)
    y = yflat.reshape(b, s, d)
    if cfg.n_shared_experts:
        h = swiglu(dense(x, p["ws_gate"]), dense(x, p["ws_up"]))
        y = y + dense(h, p["ws_down"])
    return y, aux
