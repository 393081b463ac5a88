"""The port's dense-LM serving path against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX functions and
their counterparts in the port; JAX parameters are carried over with
``convert.lm_params_from_numpy``.  On the CPU the port's attention runs the
flash kernel's plain version.  Configurations are tiny (3 layers, d_model
48, 4 query / 2 KV heads), one with tied and one with untied embeddings.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as jax_archs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import rope as jax_rope  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, NOT_PORTED, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import attention, lm, rope  # noqa: E402
from repro_torch.models.common import init_params, spec_leaves  # noqa: E402

TINY = dict(name="t", family="dense", num_layers=3, d_model=48, vocab=96,
            n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, remat="none")

#: the f32 bar of the LM checks
F32 = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _configs(tied: bool, dtype: str = "float32", **extra):
    kw = dict(TINY, tie_embeddings=tied, dtype=dtype, **extra)
    return JaxConfig(**kw).validate(), ModelConfig(**kw).validate()


def _params(jcfg, cfg, seed, dtype=jnp.float32):
    jp = jax_init_params(jax_lm.model_specs(jcfg), jax.random.PRNGKey(seed), dtype)
    tree = jax.tree.map(np.asarray, jp)
    return jp, convert.lm_params_from_numpy(tree, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    """The JAX decode step, compiled once per config (eager, every call
    would trace its layer scan anew)."""
    return jax.jit(functools.partial(jax_lm.decode_step, jcfg))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, fraction)
    got = rope.apply_rope(_t(x), _t(pos), 10_000.0, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def _qkv(seed, b, s, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, hq, d)).astype(np.float32),
            rng.normal(0, 1, (b, t, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, t, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_kernel_branch_matches_jax(causal):
    """Without cache lengths: the flash kernel's plain version on the
    [B, H, S, D] layout vs the JAX chunked online softmax (4 KV chunks)."""
    q, k, v = _qkv(5, 2, 40, 64, 6, 2, 16)
    want = jax_attention.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal, kv_chunk=16)
    got = attention.chunked_attention(*map(_t, (q, k, v)), causal=causal,
                                      kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_cache_length_branch_matches_jax(causal):
    """With cache lengths: the online softmax over KV chunks, row by row
    with a partially filled cache."""
    q, k, v = _qkv(6, 3, 8, 48, 4, 2, 12)
    kv_len = np.array([48, 17, 30], np.int32)
    want = jax_attention.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal, kv_chunk=16,
                                           kv_len=jnp.asarray(kv_len))
    got = attention.chunked_attention(*map(_t, (q, k, v)), causal=causal,
                                      kv_chunk=16, kv_len=_t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("with_len", [True, False])
def test_decode_attention_matches_jax(with_len):
    q, k, v = _qkv(7, 3, 1, 20, 6, 3, 16)
    cache_len = np.array([20, 5, 11], np.int32)
    kw_j = dict(cache_len=jnp.asarray(cache_len)) if with_len else {}
    kw_t = dict(cache_len=_t(cache_len)) if with_len else {}
    want = jax_attention.decode_attention(*map(jnp.asarray, (q, k, v)), **kw_j)
    got = attention.decode_attention(*map(_t, (q, k, v)), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


# -- the model ------------------------------------------------------------------


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_forward_and_prefill_match_jax(tied):
    jcfg, cfg = _configs(tied)
    jp, p = _params(jcfg, cfg, seed=11 + tied)
    toks = _tokens(12, (2, 12), cfg.vocab)
    want = jax.jit(functools.partial(jax_lm.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    ops.reset_launches()
    got = lm.forward(cfg, p, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want_last = jax.jit(jax_steps.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    got_last = steps.make_prefill_step(cfg)(p, {"tokens": _t(toks)})
    assert got_last.shape == (2, cfg.vocab)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), **F32)
    assert ops.LAUNCHES["flash_attention"] == 0          # CPU: the plain version


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_decode_stream_matches_jax(tied):
    """12 one-token steps from an empty cache, each feeding the step's own
    greedy token: logits at the f32 bar, tokens equal, the caches too."""
    jcfg, cfg = _configs(tied)
    jp, p = _params(jcfg, cfg, seed=21 + tied)
    b, n = 3, 12
    jstate = jax.tree.map(jnp.zeros_like, jax_init_params(
        jax_lm.decode_state_specs(jcfg, b, n), jax.random.PRNGKey(0), jnp.float32))
    state = init_params(steps.state_specs_for(cfg, b, n), torch.Generator(),
                        torch.float32, "cpu")
    jtok = ttok = _tokens(22, (b,), cfg.vocab)
    for i in range(n):
        jb = {"token": jnp.asarray(jtok)[:, None],
              "cache_len": jnp.full((b,), i, jnp.int32)}
        tb = {"token": _t(ttok)[:, None],
              "cache_len": torch.full((b,), i, dtype=torch.int32)}
        want, jstate = _jax_decode(jcfg)(jp, jstate, jb)
        got, state = lm.decode_step(cfg, p, state, tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        jtok = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        ttok = steps.make_serve_step(cfg)(p, state, tb)[0].numpy()
        np.testing.assert_array_equal(ttok, jtok)
    for kv in ("k", "v"):
        np.testing.assert_allclose(state["layers"][kv].numpy(),
                                   np.asarray(jstate["layers"][kv]), **F32)


@pytest.mark.parametrize("variant", [dict(parallel_block=True),
                                     dict(qk_norm=True),
                                     dict(ffn_act="gelu")],
                         ids=["parallel_block", "qk_norm", "gelu"])
def test_block_variants_match_jax(variant):
    """The dense block's other branches (Cohere's parallel attention + FFN,
    q/k norms, the GELU FFN): forward logits and a 6-step decode stream
    at the f32 bar."""
    jcfg, cfg = _configs(tied=False, **variant)
    jp, p = _params(jcfg, cfg, seed=51)
    toks = _tokens(52, (2, 10), cfg.vocab)
    want = jax.jit(functools.partial(jax_lm.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    got = lm.forward(cfg, p, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    b, n = 2, 6
    jstate = jax.tree.map(jnp.zeros_like, jax_init_params(
        jax_lm.decode_state_specs(jcfg, b, n), jax.random.PRNGKey(0), jnp.float32))
    state = init_params(steps.state_specs_for(cfg, b, n), torch.Generator(),
                        torch.float32, "cpu")
    for i in range(n):
        jb = {"token": jnp.asarray(toks[:, i:i + 1]),
              "cache_len": jnp.full((b,), i, jnp.int32)}
        tb = {"token": _t(toks[:, i:i + 1]),
              "cache_len": torch.full((b,), i, dtype=torch.int32)}
        want, jstate = _jax_decode(jcfg)(jp, jstate, jb)
        got, state = lm.decode_step(cfg, p, state, tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_serve_step_matches_jax_greedy_tokens():
    jcfg, cfg = _configs(tied=True)
    jp, p = _params(jcfg, cfg, seed=31)
    b, n = 2, 6
    jstate = jax.tree.map(jnp.zeros_like, jax_init_params(
        jax_lm.decode_state_specs(jcfg, b, n), jax.random.PRNGKey(0), jnp.float32))
    state = init_params(steps.state_specs_for(cfg, b, n), torch.Generator(),
                        torch.float32, "cpu")
    jserve = jax.jit(jax_steps.make_serve_step(jcfg))
    serve_step = steps.make_serve_step(cfg)
    toks = _tokens(32, (b, n), cfg.vocab)
    for i in range(n):
        cl = np.full((b,), i, np.int32)
        jt, jstate = jserve(jp, jstate, {"token": jnp.asarray(toks[:, i:i + 1]),
                                         "cache_len": jnp.asarray(cl)})
        tt, state = serve_step(p, state, {"token": _t(toks[:, i:i + 1]),
                                          "cache_len": _t(cl)})
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_bf16_forward_matches_jax():
    """bfloat16 end to end.  Held to the attention sweep's bf16 bar (rtol
    2e-2, atol 2e-1): the JAX chunked path scales q in bf16, the port's
    kernel in f32 after the cast, and other roundings differ by an ulp
    that three layers compound.  So the port must also be no further from
    the f32 model on the same weights than the JAX package's own bf16
    path is (mean and max error within 1.5x of JAX's)."""
    jcfg, cfg = _configs(tied=True, dtype="bfloat16")
    jp, p = _params(jcfg, cfg, seed=41, dtype=jnp.dtype(jcfg.dtype))
    assert p["embed"].dtype == getattr(torch, cfg.dtype)
    toks = _tokens(42, (2, 12), cfg.vocab)
    want = np.asarray(jax.jit(functools.partial(jax_lm.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks)}), np.float32)
    got = lm.forward(cfg, p, {"tokens": _t(toks)}).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-1)
    p32 = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu", dtype="float32")
    truth = lm.forward(dataclasses.replace(cfg, dtype="float32"), p32,
                       {"tokens": _t(toks)}).numpy()
    err, err_jax = np.abs(got - truth), np.abs(want - truth)
    assert err.mean() <= 1.5 * err_jax.mean(), (err.mean(), err_jax.mean())
    assert err.max() <= 1.5 * err_jax.max(), (err.max(), err_jax.max())


# -- configs, specs, conversion -------------------------------------------------


def test_smollm_config_specs_and_count_match_jax():
    jcfg, cfg = jax_get_config("smollm-360m"), get_config("smollm-360m")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == (
        32, 960, 15, 5, 64, 2560, 49152, True)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jax_lm.model_specs(jcfg),
        is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    want = {"/".join(k.key for k in path): (s.shape, s.axes, s.init, s.scale)
            for path, s in jleaves}
    got = {path: (s.shape, s.axes, s.init, s.scale)
           for path, s in spec_leaves(lm.model_specs(cfg))}
    assert got == want
    assert lm.count_params_analytic(cfg) == jax_lm.count_params_analytic(jcfg)
    for factor in (1, 4, 8):
        assert dataclasses.asdict(reduce_config(cfg, factor)) == \
            dataclasses.asdict(jax_reduce_config(jcfg, factor))


def test_registry_lists_only_ported_archs():
    assert list(ARCHS) == ["smollm-360m", "mamba2-370m", "zamba2-1.2b"]
    assert set(ARCHS) | set(NOT_PORTED) == set(jax_archs())
    for arch in NOT_PORTED:
        with pytest.raises(KeyError, match="not ported"):
            get_config(arch)
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-9")
    moe = dataclasses.replace(get_config("smollm-360m"), family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        lm.model_specs(moe)
    mla = dataclasses.replace(get_config("smollm-360m"), attn_kind="mla")
    for fn in (lm.model_specs, lambda c: lm.decode_state_specs(c, 1, 4)):
        with pytest.raises(NotImplementedError, match="dense/mla"):
            fn(mla)


def test_lm_params_from_numpy_checks_the_tree():
    jcfg, cfg = _configs(tied=False)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_lm.model_specs(jcfg), jax.random.PRNGKey(1), jnp.bfloat16))  # tracecheck: disable=TC005 — bf16 weights through the conversion
    p = convert.lm_params_from_numpy(tree, cfg, device="cpu", dtype="float32")
    np.testing.assert_array_equal(p["layers"]["wq"].numpy(),
                                  tree["layers"]["wq"].astype(np.float32))
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        convert.lm_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(KeyError, match="unembed"):
        convert.lm_params_from_numpy({k: v for k, v in tree.items()
                                      if k != "unembed"}, cfg, device="cpu")


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs(tied=True)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduce", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(lm.model_specs(cfg), torch.Generator(), torch.float32)
    tree = {k: v for k, v in init_params(lm.model_specs(cfg), torch.Generator(),
                                         torch.float32, "cpu").items()}
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_params_from_numpy(tree, cfg)


# -- the serving launcher ---------------------------------------------------------


def test_serve_main_end_to_end_on_cpu():
    argv = ["--device", "cpu", "--reduce", "8", "--batch", "3",
            "--prompt-len", "6", "--gen", "10", "--seed", "4"]
    res = serve.main(argv)
    assert res.cfg == reduce_config(get_config("smollm-360m"), 8)
    assert res.tokens.shape == (3, 10) and res.tokens.dtype == torch.int32
    assert bool(((res.tokens >= 0) & (res.tokens < res.cfg.vocab)).all())
    assert res.prefill_seconds > 0 and res.tokens_per_second > 0
    assert torch.equal(serve.main(argv).tokens, res.tokens)      # seeded
