"""Decoder-only LM over ModelConfig: the dense, SSM (Mamba2) and hybrid
(Zamba2) families.

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
which changes memory, not the numbers.  The ``ShardingCtx`` /
``activation`` constraints concern meshes and are left out.  The MoE,
MLA, VLM and enc-dec families raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as m2
from repro_torch.models.blocks import block_specs, dense_ffn, gqa_attention, gqa_decode
from repro_torch.models.common import (
    ParamSpec,
    dense,
    nll_sum,
    rms_norm,
    spec_param_count,
)

Tensor = torch.Tensor

LOSS_CHUNK = 1024         # seq tokens per unembed/CE chunk
KV_CHUNK = 1024           # KV block of the chunked attention (and its backward)


def _check_ported(cfg: ModelConfig, what: str) -> None:
    if cfg.family == "ssm" or (cfg.family in ("dense", "hybrid")
                               and cfg.attn_kind == "gqa"):
        return
    fam = (f"{cfg.family}/{cfg.attn_kind}" if cfg.family in ("dense", "hybrid")
           else cfg.family)
    raise NotImplementedError(
        f"{what}: family {fam!r} is not ported yet (the port runs the dense "
        "GQA, SSM and hybrid families)")


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


def model_specs(cfg: ModelConfig) -> dict[str, Any]:
    _check_ported(cfg, "model_specs")
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed",
                           scale=0.02),
        "final_norm": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"),
                                     scale=1.0)
    if cfg.family == "dense":
        specs["layers"] = block_specs(cfg, cfg.num_layers)
    elif cfg.family == "ssm":
        specs["layers"] = m2.mamba2_specs(cfg, cfg.num_layers)
    else:                                   # hybrid
        n_groups, per, tail = _hybrid_shape(cfg)
        specs["groups"] = _lead(m2.mamba2_specs(cfg, per), n_groups)
        if tail:
            specs["tail"] = m2.mamba2_specs(cfg, tail)
        # one shared attention block + per-invocation q-LoRA adapters
        specs["shared_attn"] = block_specs(cfg, 1)
        r = cfg.shared_attn_lora
        if r:
            specs["shared_lora_a"] = ParamSpec(
                (n_groups, d, r), (None, "embed", "lora"))
            specs["shared_lora_b"] = ParamSpec(
                (n_groups, r, d), (None, "lora", None), init="zeros")
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
                   positions: Tensor) -> Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn = gqa_attention(p, cfg, h, positions, kv_chunk=KV_CHUNK)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h)
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + dense_ffn(p, cfg, h2)


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
    x = params["embed"][batch["tokens"]]
    if cfg.tie_embeddings:
        return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def backbone(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Token embed -> blocks -> final norm: hidden [B, S, d].

    (The JAX package also returns the MoE aux loss, zero for these families.)
    """
    _check_ported(cfg, "backbone")
    x = embed_tokens(cfg, params, batch)
    b, s, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
    if cfg.family == "dense":
        block = _remat(lambda x, lp: _block_forward(cfg, lp, x, positions), cfg)
        for lp in _layers(params["layers"]):
            x = block(x, lp)
    elif cfg.family == "ssm":
        x = _mamba_stack(cfg, params["layers"], x)
    else:
        x = _hybrid_forward(cfg, params, x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed_matrix(cfg: ModelConfig, params: dict[str, Any]) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def forward(cfg: ModelConfig, params: dict[str, Any], batch) -> Tensor:
    """Full logits [B, S, vocab] (use loss_fn for training: it never
    materializes these)."""
    x = backbone(cfg, params, batch)
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
    and ``labels`` [B, S].  ``moe_aux`` is 0: the ported families have no
    MoE layer."""
    x = backbone(cfg, params, batch)
    loss, tok = chunked_ce(cfg, x, _unembed_matrix(cfg, params), batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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

    Attention layers keep ``[L, B, T, Hkv, hd]`` k and v; Mamba2 layers an
    f32 ``ssm`` state ``[..., B, H, P, N]`` and conv windows
    ``[..., B, K-1, channels]`` in the model dtype.
    """
    _check_ported(cfg, "decode_state_specs")

    def kv_cache(layers: int) -> dict[str, ParamSpec]:
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

    if cfg.family == "dense":
        return {"layers": kv_cache(cfg.num_layers)}
    if cfg.family == "ssm":
        return {"layers": ssm_state((cfg.num_layers,))}
    n_groups, per, tail = _hybrid_shape(cfg)
    out = {"groups": ssm_state((n_groups, per)), "shared": kv_cache(n_groups)}
    if tail:
        out["tail"] = ssm_state((tail,))
    return out


def _block_decode(cfg: ModelConfig, p, x, cache, positions, cache_len):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    attn, cache = gqa_decode(p, cfg, h, cache, positions, cache_len)
    if cfg.parallel_block:
        return x + attn + dense_ffn(p, cfg, h), cache
    x = x + attn
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + dense_ffn(p, cfg, h2), cache


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
    "positions": [B,1]}.  Returns (logits [B, vocab], state).

    The token is embedded without the tied-embedding scale that
    :func:`embed_tokens` applies, as the JAX package's ``decode_step`` does.
    The caches and SSM states in ``state`` are updated in place (see
    ``gqa_decode``), where the JAX package returns updated copies, and the
    returned state holds the same tensors.
    """
    _check_ported(cfg, "decode_step")
    x = params["embed"][batch["token"]]                    # [B,1,d]
    positions = batch.get("positions")
    if positions is None:
        positions = batch["cache_len"][:, None]
    cache_len = batch.get("cache_len")
    if cfg.family == "dense":
        layers, caches = params["layers"], state["layers"]
        for i in range(_depth(layers)):
            x, _ = _block_decode(cfg, _layer(layers, i), x, _layer(caches, i),
                                 positions, cache_len)
    elif cfg.family == "ssm":
        x = _mamba_decode_stack(cfg, params["layers"], state["layers"], x)
    else:
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
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x[:, 0], _unembed_matrix(cfg, params))
    return logits, state


# -- param counting ---------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameters of the model (no MoE: every parameter is active)."""
    return spec_param_count(model_specs(cfg))
