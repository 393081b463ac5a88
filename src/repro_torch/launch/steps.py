"""Step factories: prefill_step / serve_step of the LM.

The units the serving launcher and ``chip_smoke.py`` share.  Each step
runs under ``torch.no_grad()``: they serve, nothing here trains.  The
dense, SSM and hybrid families are ported; ``models.lm`` raises for the
others (enc-dec included).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import dense


def param_specs_for(cfg: ModelConfig):
    return lm.model_specs(cfg)


def state_specs_for(cfg: ModelConfig, batch: int, seq: int):
    return lm.decode_state_specs(cfg, batch, seq)


def make_prefill_step(cfg: ModelConfig):
    """Prefill: hidden states -> LAST-position logits only ``[B, vocab]``
    (the ``[B, S, V]`` logits tensor is never materialized).  The cache is
    not written out, as in the JAX package."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x = lm.backbone(cfg, params, batch)
        return dense(x[:, -1], lm._unembed_matrix(cfg, params))

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token greedy decode against the cache: ``(token [B] int32, state)``."""

    @torch.no_grad()
    def serve_step(params, state, batch):
        logits, state = lm.decode_step(cfg, params, state, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step
