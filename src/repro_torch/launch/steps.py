"""Step factories: train_step / prefill_step / serve_step of the LM.

The units the launchers, the live-twin example and ``chip_smoke.py``
share.  ``train_step`` takes gradients with ``torch.autograd.grad`` over
the parameter leaves and applies one AdamW step; the prefill and serve
steps run under ``torch.no_grad()``.  Every family of the registry
trains, serves and prefills: ``loss_for`` gives the enc-dec family
``encdec.encdec_loss`` (its batch carries ``frames`` beside ``tokens`` and
``labels``) and every decoder-only family ``lm.loss_fn``, as the JAX
package's.  Each factory takes a ``ShardingCtx`` and binds it with
``use_ctx`` for the length of a step, so the MoE layers split their
experts over its mesh (``models/moe.py``).
"""

from __future__ import annotations

import torch

from repro_torch._tree import flatten, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ed
from repro_torch.models import lm
from repro_torch.models.common import dense
from repro_torch.optim.adamw import AdamWConfig, apply_updates
from repro_torch.parallel.sharding import ShardingCtx, argmax_last, use_ctx


def loss_for(cfg: ModelConfig):
    if cfg.family == "encdec":
        return ed.encdec_loss
    return lm.loss_fn


def param_specs_for(cfg: ModelConfig):
    if cfg.family == "encdec":
        return ed.encdec_specs(cfg)
    return lm.model_specs(cfg)


def state_specs_for(cfg: ModelConfig, batch: int, seq: int):
    if cfg.family == "encdec":
        return ed.encdec_state_specs(cfg, batch, seq)
    return lm.decode_state_specs(cfg, batch, seq)


def make_prefill_step(cfg: ModelConfig, ctx: ShardingCtx = ShardingCtx()):
    """Prefill: hidden states -> LAST-position logits only ``[B, vocab]``
    (the ``[B, S, V]`` logits tensor is never materialized).  The cache is
    not written out, as in the JAX package.  The enc-dec family reads
    ``frames`` [B, F, d] beside ``tokens``."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with use_ctx(ctx):
            return _prefill(params, batch)

    def _prefill(params, batch):
        if cfg.family == "encdec":
            enc_out = ed.encode(cfg, params, batch["frames"], ctx)
            x = ed.decode_train(cfg, params, batch["tokens"], enc_out, ctx)
            w = params["unembed"]
        else:
            x, _ = lm.backbone(cfg, params, batch, ctx)
            w = lm._unembed_matrix(cfg, params)
        return dense(x[:, -1], w)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx: ShardingCtx = ShardingCtx()):
    """One-token greedy decode against the cache: ``(token [B] int32, state)``."""

    @torch.no_grad()
    def serve_step(params, state, batch):
        with use_ctx(ctx):
            return _serve(params, state, batch)

    def _serve(params, state, batch):
        if cfg.family == "encdec":
            logits, state = ed.encdec_decode_step(cfg, params, state, batch, ctx)
        else:
            logits, state = lm.decode_step(cfg, params, state, batch, ctx)
        return argmax_last(logits).to(torch.int32), state

    return serve_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    ctx: ShardingCtx = ShardingCtx(), grad_accum: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params', opt_state', metrics)``, pure (the inputs are not changed).

    metrics: ``loss, ce, moe_aux, tokens, grad_norm, lr`` as tensors.
    ``grad_accum`` > 1 splits the batch into that many microbatches, one
    after another, sums their float32 gradients and takes the mean; its
    metrics are those of the JAX package's accumulating path (``ce`` the
    mean loss, ``moe_aux`` and ``tokens`` zero).
    """
    loss_fn = loss_for(cfg)

    def _grads(params, batch):
        flat, unflatten = flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = loss_fn(cfg, unflatten(leaves), batch, ctx)
        # a leaf the loss does not read (a hybrid stack too shallow for
        # its shared block) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            unflatten(list(grads))

    def train_step(params, opt_state, batch):
        with use_ctx(ctx):
            return _train(params, opt_state, batch)

    def _train(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = _grads(params, batch)
        else:
            def split(x):
                b = x.shape[0] if x.dim() and x.shape[0] > 3 else None
                if b is None or b % grad_accum:
                    raise ValueError("batch not divisible by grad_accum")
                return x.reshape((grad_accum, b // grad_accum) + tuple(x.shape[1:]))

            micro = {k: split(v) for k, v in batch.items() if k != "positions"}
            dev = next(iter(micro.values())).device
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(grad_accum):
                l, _, g = _grads(params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b_: a + b_.float(), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {"ce": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32, device=dev),
                       "tokens": torch.zeros((), dtype=torch.int32, device=dev)}
        params, opt_state, om = apply_updates(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step
