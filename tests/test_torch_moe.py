"""The port's MoE FFN against the JAX package.

Same inputs, made from a seed with numpy, go through ``repro.models.moe``
and ``repro_torch.models.moe`` in float32 on the CPU: the router's top-k
(with every logit tied, which pins the order among ties), the capacity
positions and drops, the expert outputs and the load-balance loss; the
shared experts and ``router_scale`` through ``moe_ffn``; then the two MoE
architectures (Qwen1.5-MoE; DeepSeek-V2-Lite with its dense layer 0 and
MLA) end to end through ``reduce_config(..., 8)``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.parallel.sharding import ShardingCtx  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_lm import arch_parity  # noqa: E402

#: the f32 bar of y and aux
Y_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for the port's ops in this module (the suite runs in
    several processes at once); the count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    base = dict(name="t", family="moe", num_layers=1, d_model=16, vocab=8,
                moe=True, n_experts=6, top_k=2, moe_d_ff=8, remat="none")
    base.update(kw)
    return JaxConfig(**base).validate(), ModelConfig(**base).validate()


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(cfg, seed, tokens, router_scale=1.0):
    rng = np.random.default_rng(seed)
    e, d, f = moe.padded_experts(cfg), cfg.d_model, cfg.moe_d_ff
    return dict(
        x=rng.normal(0, 1, (tokens, d)).astype(np.float32),
        router=(router_scale * rng.normal(0, 1, (d, cfg.n_experts))).astype(np.float32),
        w_gate=rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32),
        w_up=rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32),
        w_down=rng.normal(0, f ** -0.5, (e, f, d)).astype(np.float32))


def _jax_routing(jcfg, x, router, e_pad):
    """The JAX package's router and dispatch (``repro/models/moe.py``
    ``_moe_local``, the lines from the logits to ``slot_idx``, with one
    shard: every expert owned) on its own arrays: ``(ids, keep, slot_idx)``
    as numpy, ``[T, k]`` each."""
    logits = jax_moe.dense(jnp.asarray(x), jnp.asarray(router)).astype(jnp.float32)
    if e_pad > jcfg.n_experts:
        logits = jnp.pad(logits, ((0, 0), (0, e_pad - jcfg.n_experts)),
                         constant_values=-1e30)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    cap = jax_moe._capacity(x.shape[0], jcfg)
    counts = jnp.zeros((e_pad,), jnp.int32)
    keeps, slots = [], []
    for slot in range(jcfg.top_k):
        lid = ids[:, slot]
        oh = jax.nn.one_hot(lid, e_pad, dtype=jnp.int32)
        pos = jnp.sum((counts[None, :] + jnp.cumsum(oh, axis=0) - oh) * oh, axis=1)
        counts = counts + oh.sum(axis=0)
        keep = pos < cap
        keeps.append(keep)
        slots.append(jnp.where(keep, lid * cap + pos, e_pad * cap))
    return (np.asarray(ids), np.stack([np.asarray(k) for k in keeps], 1),
            np.stack([np.asarray(s) for s in slots], 1))


@pytest.mark.parametrize("case", ["random", "ties", "scaled"])
def test_moe_local_routing_drops_and_outputs_match_jax(case):
    """64 tokens at capacity factor 0.25 (capacity 8 a padded expert, 16
    tokens a real expert on average): ids, keep and slot_idx equal, tokens
    dropped; y and aux at the f32 bar.  ``ties``: the router zeroed, every
    real expert's probability equal, so the order among ties decides (the
    lower index first, as ``jax.lax.top_k``); ``scaled``: DeepSeek's
    normalized gates."""
    jcfg, cfg = _configs(capacity_factor=0.25, router_scale=case == "scaled",
                         top_k=3 if case == "scaled" else 2)
    w = _weights(cfg, 7, 64, router_scale=0.0 if case == "ties" else 1.0)
    e_pad = moe.padded_experts(cfg)
    cap = moe._capacity(64, cfg)
    assert cap == jax_moe._capacity(64, jcfg) == 8
    ids, keep, slot = _jax_routing(jcfg, w["x"], w["router"], e_pad)
    _, _, got_ids = moe.route(_t(w["x"]), _t(w["router"]), cfg, e_pad)
    got_keep, got_slot = moe.dispatch(got_ids, e_pad, 0, cap)
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_array_equal(got_slot.numpy(), slot)
    assert 0 < int((~keep).sum()) < keep.size          # some tokens dropped
    if case == "ties":
        assert (ids == np.arange(cfg.top_k)).all()
    y, aux = jax_moe._moe_local(*(jnp.asarray(w[k]) for k in
                                  ("x", "router", "w_gate", "w_up", "w_down")),
                                cfg=jcfg, e0=0, n_shards=1)
    got_y, got_aux = moe._moe_local(*(_t(w[k]) for k in
                                      ("x", "router", "w_gate", "w_up", "w_down")),
                                    cfg=cfg, e0=0, n_shards=1)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **Y_TOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), **Y_TOL)


@pytest.mark.parametrize("tokens", [1, 8, 100, 8192])
def test_capacity_matches_jax(tokens):
    for n_experts, top_k in ((60, 4), (64, 6), (6, 2)):
        jcfg, cfg = _configs(n_experts=n_experts, top_k=top_k)
        assert moe._capacity(tokens, cfg) == jax_moe._capacity(tokens, jcfg)
        assert moe.padded_experts(cfg) == jax_moe.padded_experts(jcfg)


def test_moe_ffn_with_shared_experts_matches_jax():
    """``moe_ffn`` on [B, S, d]: routed experts (normalized gates) plus the
    shared experts' SwiGLU, against the JAX package's mesh-less branch."""
    jcfg, cfg = _configs(n_shared_experts=2, shared_d_ff=12, router_scale=True,
                         top_k=3)
    rng = np.random.default_rng(3)
    w = _weights(cfg, 4, 1)
    p = {k: w[k] for k in ("router", "w_gate", "w_up", "w_down")}
    for k, shape in (("ws_gate", (16, 12)), ("ws_up", (16, 12)), ("ws_down", (12, 16))):
        p[k] = rng.normal(0, shape[0] ** -0.5, shape).astype(np.float32)
    x = rng.normal(0, 1, (3, 10, 16)).astype(np.float32)
    y, aux = jax_moe.moe_ffn(ShardingCtx(), jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got_y, got_aux = moe.moe_ffn(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    assert got_y.shape == (3, 10, 16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), **Y_TOL)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), **Y_TOL)
    with pytest.raises(TypeError):
        moe.moe_ffn(cfg, {k: _t(v) for k, v in p.items()}, _t(x), mesh=None)


def test_moe_specs_match_jax():
    for kw in (dict(), dict(n_shared_experts=4, shared_d_ff=32)):
        jcfg, cfg = _configs(**kw)
        want = jax_moe.moe_specs(jcfg, 3)
        got = moe.moe_specs(cfg, 3)
        assert {k: dataclasses.astuple(s) for k, s in got.items()} == \
            {k: (s.shape, s.axes, s.init, s.scale, s.dtype) for k, s in want.items()}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_moe_arch_prefill_and_greedy_serve_match_jax(arch):
    arch_parity(arch)


def test_backbone_returns_the_moe_aux_of_jax():
    """The backbone's summed MoE aux over DeepSeek's reduced stack (a dense
    layer, then MoE layers) equals the JAX package's, hidden states too."""
    from repro.models import lm as jax_lm
    from repro_torch.models import lm
    from test_torch_lm import arch_batch, arch_configs, arch_params

    jcfg, cfg = arch_configs("deepseek-v2-lite-16b")
    jp, p = arch_params(jcfg, cfg, 5)
    tokens = arch_batch(cfg, 2, 24, 6)["tokens"]
    (x, aux) = jax_lm.backbone(jcfg, jp, {"tokens": jnp.asarray(tokens)}, ShardingCtx())
    got_x, got_aux = lm.backbone(cfg, p, {"tokens": _t(tokens)})
    assert float(got_aux) > 0
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), **Y_TOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(x), rtol=1e-4, atol=1e-4)
