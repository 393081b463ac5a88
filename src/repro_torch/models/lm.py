"""Decoder-only LM over ModelConfig: dense / MoE / MLA / SSM (Mamba2) /
hybrid (Zamba2) / VLM (Qwen2-VL backbone).  The enc-dec family lives in
``models/encdec.py``.

Single source of truth per architecture, as in the JAX package:
  model_specs(cfg)        -> ParamSpec tree (init, weight conversion)
  forward(cfg, p, batch)  -> [B, S, vocab] logits
  loss_fn(...)            -> scalar CE, seq-chunked so the full [B, S, V]
                             logits tensor never materializes
  decode_state_specs(cfg) -> cache/state ParamSpec tree
  decode_step(...)        -> one-token serve step over the cache

The JAX package scans the stacked ``[L, ...]`` layer parameters; here the
model loops over ``L`` (the stacks are unbound once, so a gradient flows
back to each stack in one op).  ``cfg.remat`` holds as in the JAX
package while gradients are on: each block, each Mamba2 layer and each
CE chunk is a ``torch.utils.checkpoint`` region whose activations are
recomputed in the backward.  ``"full"`` and ``"dots"`` both recompute the
whole region: JAX's ``"dots"`` policy keeps the matmul outputs instead,
which changes memory, not the numbers.  The MoE layers read the ambient
``ShardingCtx`` (``parallel.sharding.use_ctx``, bound by the step
factories) and split their experts over its mesh's ``model`` axis as the
JAX package's do; the JAX package's ``activation`` constraints, which in
one process move nothing (``sharding.activation`` returns its input), are
left out.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla
from repro_torch.models import moe as moe_mod
from repro_torch.models.blocks import attn_specs, dense_ffn, ffn_specs, gqa_attention, gqa_decode
from repro_torch.models.common import (
    ParamSpec,
    dense,
    nll_sum,
    rms_norm,
    spec_param_count,
)
from repro_torch.parallel.sharding import ShardingCtx, current_ctx

Tensor = torch.Tensor

LOSS_CHUNK = 1024         # seq tokens per unembed/CE chunk
KV_CHUNK = 1024           # KV block of the chunked attention (and its backward)


def _hybrid_shape(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(n_groups, layers per group, tail layers)`` of the hybrid stack."""
    per = cfg.shared_attn_every
    n_groups = cfg.num_layers // per
    return n_groups, per, cfg.num_layers - n_groups * per


# -- specs -----------------------------------------------------------------


def _lead(specs: dict[str, ParamSpec], n: int) -> dict[str, ParamSpec]:
    """The same specs with a leading axis of ``n`` (the hybrid's groups)."""
    return {k: ParamSpec((n,) + s.shape, (None,) + s.axes, init=s.init,
                         scale=s.scale, dtype=s.dtype) for k, s in specs.items()}


def _layer_specs(cfg: ModelConfig, L: int, moe_layer: bool) -> dict[str, ParamSpec]:
    d = cfg.d_model
    s: dict[str, ParamSpec] = {
        "ln1": ParamSpec((L, d), (None, None), init="ones")}
    if cfg.attn_kind == "mla":
        s.update(mla.mla_specs(cfg, L))
    else:
        s.update(attn_specs(cfg, L))
    if not cfg.parallel_block:
        s["ln2"] = ParamSpec((L, d), (None, None), init="ones")
    if moe_layer:
        s.update(moe_mod.moe_specs(cfg, L))
    else:
        s.update(ffn_specs(cfg, L))
    return s


def model_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed",
                           scale=0.02),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"),
                                     scale=1.0)
    if cfg.family in ("dense", "vlm"):
        specs["layers"] = _layer_specs(cfg, cfg.num_layers, moe_layer=False)
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            specs["dense_layers"] = _layer_specs(cfg, nd, moe_layer=False)
        specs["layers"] = _layer_specs(cfg, cfg.num_layers - nd, moe_layer=True)
    elif cfg.family == "ssm":
        specs["layers"] = m2.mamba2_specs(cfg, cfg.num_layers)
    elif cfg.family == "hybrid":
        n_groups, per, tail = _hybrid_shape(cfg)
        specs["groups"] = _lead(m2.mamba2_specs(cfg, per), n_groups)
        if tail:
            specs["tail"] = m2.mamba2_specs(cfg, tail)
        # one shared attention block + per-invocation q-LoRA adapters
        specs["shared_attn"] = _layer_specs(cfg, 1, moe_layer=False)
        r = cfg.shared_attn_lora
        if r:
            specs["shared_lora_a"] = ParamSpec(
                (n_groups, d, r), (None, "embed", "lora"))
            specs["shared_lora_b"] = ParamSpec(
                (n_groups, r, d), (None, "lora", None), init="zeros")
    else:
        raise ValueError(f"model_specs: family {cfg.family} (encdec lives in"
                         " models/encdec.py)")
    return specs


def _layer(stacked: dict[str, Tensor], i: int) -> dict[str, Tensor]:
    return {k: t[i] for k, t in stacked.items()}


def _depth(stacked: dict[str, Tensor]) -> int:
    return next(iter(stacked.values())).shape[0]


def _layers(stacked: dict[str, Tensor]) -> list[dict[str, Tensor]]:
    """Every layer's parameters, as views of the stack (one ``unbind`` a
    leaf: its gradient is one stack, not a full-size scatter a layer)."""
    keys = list(stacked)
    return [dict(zip(keys, vals))
            for vals in zip(*(stacked[k].unbind(0) for k in keys))]


def _remat(fn, cfg: ModelConfig):
    """``fn`` as a checkpointed region under ``cfg.remat`` while gradients
    are on (see the module docstring); as is otherwise."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# -- forward ------------------------------------------------------------------


def _block_forward(cfg: ModelConfig, p: dict[str, Tensor], x: Tensor,
                   positions: Tensor, moe_layer: bool = False,
                   ctx: ShardingCtx | None = None
                   ) -> tuple[Tensor, Tensor | None]:
    """One block: ``(x', MoE aux)``, the aux None but in a MoE layer."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn = mla.mla_prefill(p, cfg, h, positions, kv_chunk=KV_CHUNK)
    else:
        attn = gqa_attention(p, cfg, h, positions, kv_chunk=KV_CHUNK)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h), None
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe_layer:
        f, aux = moe_mod.moe_ffn(cfg, p, h2, ctx)
        return x + f, aux
    return x + dense_ffn(p, cfg, h2), None


def _block_stack(cfg: ModelConfig, stacked: dict[str, Tensor], x: Tensor,
                 positions: Tensor, moe_layer: bool) -> tuple[Tensor, Tensor]:
    """The blocks of a stack, each a remat region: ``(x, summed MoE aux)``
    (0 in a stack without MoE layers).  The ambient ``ShardingCtx`` is read
    here, once: a region's recompute runs in the backward, on the autograd
    engine's thread for a card, where the context variable is not bound."""
    ctx = current_ctx()
    block = _remat(lambda x, lp: _block_forward(cfg, lp, x, positions, moe_layer, ctx),
                   cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(stacked):
        x, a = block(x, lp)
        if a is not None:
            aux = aux + a
    return x, aux


def _mamba_stack(cfg: ModelConfig, stacked: dict[str, Tensor], x: Tensor
                 ) -> Tensor:
    """Pre-norm residual Mamba2 blocks over the stack's leading axis."""
    def body(x, lp):
        return x + m2.mamba2_forward(lp, cfg, rms_norm(x, lp["norm_in"], cfg.norm_eps))

    body = _remat(body, cfg)
    for lp in _layers(stacked):
        x = body(x, lp)
    return x


def _shared_block(cfg: ModelConfig, params: dict[str, Any], gi: int, x: Tensor,
                  attend) -> Tensor:
    """The hybrid's shared attention block at its ``gi``-th invocation:
    ``attend(p, h)`` is the attention (prefill or decode), plus the
    invocation's q-LoRA term, then the shared FFN."""
    sp = _layer(params["shared_attn"], 0)
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    attn = attend(sp, h)
    if cfg.shared_attn_lora:
        attn = attn + dense(dense(h, params["shared_lora_a"][gi]),
                            params["shared_lora_b"][gi])
    x = x + attn
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + dense_ffn(sp, cfg, h2)


def _hybrid_forward(cfg: ModelConfig, params: dict[str, Any], x: Tensor,
                    positions: Tensor) -> Tensor:
    n_groups, _, tail = _hybrid_shape(cfg)
    attend = lambda sp, h: gqa_attention(sp, cfg, h, positions, kv_chunk=KV_CHUNK)  # noqa: E731
    for gi, group in enumerate(_layers(params["groups"])):
        x = _shared_block(cfg, params, gi, x, attend)
        x = _mamba_stack(cfg, group, x)
    if tail:
        x = _mamba_stack(cfg, params["tail"], x)
    return x


def embed_tokens(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Token embeddings ``[B, S, d]``; for the VLM family the batch's
    ``vision_embeds`` [B, P, d] (the stub frontend's patch embeddings) are
    written over the rows at ``vision_pos`` [B, P].  More patches than
    rows (``P > S``) raise ``ValueError``, where the JAX package's scatter
    drops the rows past the sequence."""
    x = params["embed"][batch["tokens"]]
    if cfg.family == "vlm" and "vision_embeds" in batch:
        p, s = batch["vision_embeds"].shape[1], x.shape[1]
        if p > s:
            raise ValueError(f"{p} patch embeddings do not fit a sequence of {s} tokens")
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        x[bidx, batch["vision_pos"].long()] = batch["vision_embeds"].to(x.dtype)
    if cfg.tie_embeddings:
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _default_positions(cfg: ModelConfig, b: int, s: int, start, device
                       ) -> Tensor:
    """Positions where the batch gives none: ``start + arange(s)`` per row
    ([B, S]); with M-RoPE the three streams alike ([3, B, S], a text-only
    sequence).  ``start`` is an int or a [B] tensor."""
    pos = torch.arange(s, dtype=torch.int32, device=device) + (
        start[:, None] if isinstance(start, Tensor) else start)
    pos = pos.to(torch.int32).expand(b, s)
    return pos.expand(3, b, s) if cfg.mrope else pos


def backbone(cfg: ModelConfig, params: dict[str, Any], batch
             ) -> tuple[Tensor, Tensor]:
    """Token embed -> blocks -> final norm.  Returns (hidden [B, S, d], MoE
    aux), the aux summed over the MoE layers (0 without any).

    ``batch["positions"]``: [B, S], or [3, B, S] with M-RoPE (Qwen2-VL's
    temporal/height/width streams); by default ``arange(S)`` in each.
    """
    x = embed_tokens(cfg, params, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, b, s, 0, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm"):
        x, aux = _block_stack(cfg, params["layers"], x, positions, False)
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            x, _ = _block_stack(cfg, params["dense_layers"], x, positions, False)
        x, aux = _block_stack(cfg, params["layers"], x, positions, True)
    elif cfg.family == "ssm":
        x = _mamba_stack(cfg, params["layers"], x)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions)
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _unembed_matrix(cfg: ModelConfig, params: dict[str, Any]) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Full logits [B, S, vocab] (use loss_fn for training: it never
    materializes these)."""
    x, _ = backbone(cfg, params, batch)
    return dense(x, _unembed_matrix(cfg, params))


def chunked_ce(cfg: ModelConfig, x: Tensor, w: Tensor, labels: Tensor
               ) -> tuple[Tensor, Tensor]:
    """Seq-chunked CE: logits chunks of [B, LOSS_CHUNK, V], never [B, S, V].

    Returns (mean NLL over the non-ignored labels, their count).  The
    sequence is cut into ``max(S // LOSS_CHUNK, 1)`` equal chunks, as in
    the JAX package; a length they do not divide raises.
    """
    s = x.shape[1]
    chunk = min(LOSS_CHUNK, s)
    n = max(s // chunk, 1)
    chunk = s // n
    if s % chunk:
        raise ValueError(f"sequence length {s} is not {n} CE chunks of {chunk}")
    ce_chunk = _remat(lambda xc, yc: _ce_sums(dense(xc, w), yc), cfg)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    tok = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll_sum, cnt = ce_chunk(x[:, sl], labels[:, sl])
        loss_sum, tok = loss_sum + nll_sum, tok + cnt
    return loss_sum / tok.clamp(min=1), tok


def loss_fn(cfg: ModelConfig, params: dict[str, Any], batch,
            aux_weight: float = 0.01) -> tuple[Tensor, dict[str, Tensor]]:
    """``(total, {"ce", "moe_aux", "tokens"})`` of a batch with ``tokens``
    and ``labels`` [B, S]; ``moe_aux`` is the MoE layers' load-balance loss
    (0 without any)."""
    x, aux = backbone(cfg, params, batch)
    loss, tok = chunked_ce(cfg, x, _unembed_matrix(cfg, params), batch["labels"])
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux, "tokens": tok}


def _ce_sums(logits: Tensor, labels: Tensor, ignore: int = -100
             ) -> tuple[Tensor, Tensor]:
    """``(sum of the NLL over non-ignored labels in float32, their count
    int32)``."""
    total, n = nll_sum(logits, labels, ignore)
    return total, n.to(torch.int32)


# -- decode ---------------------------------------------------------------------


def decode_state_specs(cfg: ModelConfig, batch: int, seq: int
                       ) -> dict[str, Any]:
    """Cache/state ParamSpec tree for serve_step.

    Attention layers keep ``[L, B, T, Hkv, hd]`` k and v (MLA: the latent
    ``c_kv [L, B, T, kv_lora]`` and ``k_rope [L, B, T, qk_rope]``); Mamba2
    layers an f32 ``ssm`` state ``[..., B, H, P, N]`` and conv windows
    ``[..., B, K-1, channels]`` in the model dtype.  Every leaf starts at
    zero (the JAX package draws the latent cache at random and its
    launcher zeroes it).
    """
    def kv_cache(layers: int) -> dict[str, ParamSpec]:
        if cfg.attn_kind == "mla":
            axes = (None, "batch", "cache_seq", None)
            return {
                "c_kv": ParamSpec((layers, batch, seq, cfg.kv_lora), axes,
                                  init="zeros"),
                "k_rope": ParamSpec((layers, batch, seq, cfg.qk_rope_dim), axes,
                                    init="zeros"),
            }
        shp = (layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        axes = (None, "batch", "cache_seq", "cache_heads", None)
        return {"k": ParamSpec(shp, axes, init="zeros"),
                "v": ParamSpec(shp, axes, init="zeros")}

    def ssm_state(lead: tuple[int, ...]) -> dict[str, ParamSpec]:
        h, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.d_state
        gn = cfg.ssm_ngroups * cfg.d_state
        k = cfg.d_conv
        la = (None,) * len(lead)
        return {
            "ssm": ParamSpec(lead + (batch, h, pdim, n),
                             la + ("batch", "cache_heads", None, None),
                             init="zeros", dtype="float32"),
            "conv_x": ParamSpec(lead + (batch, k - 1, cfg.d_inner),
                                la + ("batch", None, "ssm_inner"),
                                init="zeros"),
            "conv_B": ParamSpec(lead + (batch, k - 1, gn),
                                la + ("batch", None, None), init="zeros"),
            "conv_C": ParamSpec(lead + (batch, k - 1, gn),
                                la + ("batch", None, None), init="zeros"),
        }

    if cfg.family in ("dense", "vlm"):
        return {"layers": kv_cache(cfg.num_layers)}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        out: dict[str, Any] = {"layers": kv_cache(cfg.num_layers - nd)}
        if nd:
            out["dense_layers"] = kv_cache(nd)
        return out
    if cfg.family == "ssm":
        return {"layers": ssm_state((cfg.num_layers,))}
    if cfg.family == "hybrid":
        n_groups, per, tail = _hybrid_shape(cfg)
        out = {"groups": ssm_state((n_groups, per)), "shared": kv_cache(n_groups)}
        if tail:
            out["tail"] = ssm_state((tail,))
        return out
    raise ValueError(cfg.family)


def _block_decode(cfg: ModelConfig, p, x, cache, positions, cache_len,
                  moe_layer: bool = False):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn, cache = mla.mla_decode(p, cfg, h, cache, positions, cache_len)
    else:
        attn, cache = gqa_decode(p, cfg, h, cache, positions, cache_len)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h), cache
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = moe_mod.moe_ffn(cfg, p, h2)[0] if moe_layer else dense_ffn(p, cfg, h2)
    return x + f, cache


def _block_decode_stack(cfg: ModelConfig, stacked, caches, x, positions,
                        cache_len, moe_layer: bool) -> Tensor:
    """One token through a stack of blocks, each layer's cache written in
    place."""
    for i in range(_depth(stacked)):
        x, _ = _block_decode(cfg, _layer(stacked, i), x, _layer(caches, i),
                             positions, cache_len, moe_layer)
    return x


def _mamba_decode_stack(cfg: ModelConfig, stacked: dict[str, Tensor],
                        states: dict[str, Tensor], x: Tensor) -> Tensor:
    """One token through a Mamba2 stack; each layer's state is overwritten
    in place with its update."""
    for i in range(_depth(stacked)):
        lp, lc = _layer(stacked, i), _layer(states, i)
        y, new = m2.mamba2_decode(lp, cfg, rms_norm(x, lp["norm_in"], cfg.norm_eps),
                                  lc)
        for k, v in new.items():
            lc[k].copy_(v)
        x = x + y
    return x


def decode_step(cfg: ModelConfig, params: dict[str, Any],
                state: dict[str, Any], batch) -> tuple[Tensor, dict[str, Any]]:
    """One-token decode.  batch: {"token": [B,1], "cache_len": [B],
    "positions": [B,1] or [3,B,1] (M-RoPE)}.  Returns (logits [B, vocab],
    state).  Without ``positions`` the token sits at ``cache_len`` (in all
    three M-RoPE streams).

    The token is embedded without the tied-embedding scale that
    :func:`embed_tokens` applies, as the JAX package's ``decode_step`` does.
    The caches and SSM states in ``state`` are updated in place (see
    ``gqa_decode``), where the JAX package returns updated copies, and the
    returned state holds the same tensors.
    """
    x = params["embed"][batch["token"]]                    # [B,1,d]
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(cfg, x.shape[0], 1, batch["cache_len"],
                                       x.device)
    cache_len = batch.get("cache_len")
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.family == "moe" and cfg.first_dense_layers:
            x = _block_decode_stack(cfg, params["dense_layers"],
                                    state["dense_layers"], x, positions,
                                    cache_len, False)
        x = _block_decode_stack(cfg, params["layers"], state["layers"], x,
                                positions, cache_len, cfg.family == "moe")
    elif cfg.family == "ssm":
        x = _mamba_decode_stack(cfg, params["layers"], state["layers"], x)
    elif cfg.family == "hybrid":
        n_groups, _, tail = _hybrid_shape(cfg)
        for gi in range(n_groups):
            cache = _layer(state["shared"], gi)
            attend = lambda sp, h, c=cache: gqa_decode(  # noqa: E731
                sp, cfg, h, c, positions, cache_len)[0]
            x = _shared_block(cfg, params, gi, x, attend)
            x = _mamba_decode_stack(cfg, _layer(params["groups"], gi),
                                    _layer(state["groups"], gi), x)
        if tail:
            x = _mamba_decode_stack(cfg, params["tail"], state["tail"], x)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0], _unembed_matrix(cfg, params))
    return logits, state


# -- param counting ---------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the model from its specs alone (nothing allocated).

    MoE: the padded experts' weights are not counted, and with
    ``active_only`` neither are the routed experts a token does not use
    (its top-k and the shared experts are active).
    """
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_specs

        return spec_param_count(encdec_specs(cfg))
    total = spec_param_count(model_specs(cfg))
    if cfg.moe:
        e_pad = moe_mod.padded_experts(cfg)
        n_moe_layers = cfg.num_layers - cfg.first_dense_layers
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        total -= n_moe_layers * per_expert * (e_pad - cfg.n_experts)  # padding
        if active_only:
            total -= n_moe_layers * per_expert * (cfg.n_experts - cfg.top_k)
    return total
