"""The port's LM serving path against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX functions and
their counterparts in the port; JAX parameters are carried over with
``convert.lm_params_from_numpy``.  On the CPU the port's attention runs the
flash kernel's plain version.  Configurations are tiny (3 layers, d_model
48, 4 query / 2 KV heads), one with tied and one with untied embeddings;
then M-RoPE, ``layer_norm``, the registry, every full config's parameter
counts, and the serving parity of each architecture through
``reduce_config(..., 8)`` (``arch_parity``, which the MoE, MLA and enc-dec
test files also run for theirs).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SUBQUADRATIC as JAX_SUBQUADRATIC  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import all_archs as jax_archs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.configs.base import active_param_count as jax_active_param_count  # noqa: E402
from repro.configs.base import param_count as jax_param_count  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import rope as jax_rope  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, SUBQUADRATIC, all_archs, get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, active_param_count, param_count  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import attention, common, encdec, lm, rope  # noqa: E402
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
    """The registry is the JAX package's, in its order, with its
    sub-quadratic set; every id gives the JAX config field for field."""
    assert ARCHS == JAX_ARCHS and list(ARCHS) == jax_archs() == all_archs()
    assert SUBQUADRATIC == JAX_SUBQUADRATIC
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-9")
    enc = get_config("seamless-m4t-medium")
    with pytest.raises(ValueError, match="encdec"):
        lm.model_specs(enc)
    assert steps.loss_for(enc) is encdec.encdec_loss


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


# -- M-RoPE, layer_norm ------------------------------------------------------------


@pytest.mark.parametrize("sections", [(16, 24, 24), (2, 3, 3)])
def test_apply_mrope_matches_jax(sections):
    """Qwen2-VL's sections (head dim 128) and the reduced config's (16):
    three position streams of their own, rtol 1e-6."""
    d = 2 * sum(sections)
    rng = np.random.default_rng(d)
    x = rng.normal(0, 1, (2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 700, (3, 2, 9)).astype(np.int32)
    want = jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = rope.apply_mrope(_t(x), _t(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(_t(x), _t(pos), 1e6, (1, 1, 1))


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(3, 2, (4, 5, 24)).astype(np.float32)
    g, b = rng.normal(1, 0.1, 24).astype(np.float32), rng.normal(0, 0.1, 24).astype(np.float32)
    want = jax_common.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)
    got = common.layer_norm(_t(x), _t(g), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# -- every architecture ----------------------------------------------------------


def _spec_tree(specs):
    """``{path: (shape, axes, init, scale, dtype)}`` of a spec tree of either
    package."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    return {"/".join(k.key for k in path): (s.shape, s.axes, s.init, s.scale, s.dtype)
            for path, s in flat}


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_full_config_specs_and_counts_match_jax(arch):
    """Each full config: the parameter spec tree equal to the JAX
    package's, the analytic parameter count and the active count (MoE:
    padding and unrouted experts out) equal, from the specs alone."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = (jax_steps.param_specs_for(jcfg))
    assert _spec_tree(steps.param_specs_for(cfg)) == _spec_tree(want)
    assert param_count(cfg) == jax_param_count(jcfg)
    assert active_param_count(cfg) == jax_active_param_count(jcfg)
    assert lm.count_params_analytic(cfg, active_only=True) == \
        jax_lm.count_params_analytic(jcfg, active_only=True)
    for factor in (4, 8):
        assert dataclasses.asdict(reduce_config(cfg, factor)) == \
            dataclasses.asdict(jax_reduce_config(jcfg, factor))


def np_spec_params(specs, seed):
    """Numpy float32 leaves of a JAX spec tree, drawn by the law of its
    ``init_params`` (fan-in scaled normals, embeddings, zeros, ones):
    ``jax.random`` would compile once per leaf shape."""
    rng = np.random.default_rng(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, float(spec.init == "ones"), np.float32)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.init == "embed" else spec.scale / max(fan_in, 1) ** 0.5
        return rng.normal(0, std, spec.shape).astype(np.float32)

    return jax.tree.map(one, specs, is_leaf=lambda x: isinstance(x, jax_common.ParamSpec))


def arch_configs(arch: str, factor: int = 8):
    """The JAX and the port's config of ``arch`` through
    ``reduce_config(..., factor)``, in float32, no remat."""
    kw = dict(dtype="float32", remat="none")
    return (dataclasses.replace(jax_reduce_config(jax_get_config(arch), factor), **kw),
            dataclasses.replace(reduce_config(get_config(arch), factor), **kw))


def arch_batch(cfg, b: int, s: int, seed: int) -> dict:
    """A prefill batch as numpy: ``tokens`` [B, S]; the VLM's [3, B, S]
    M-RoPE positions (a patch grid of 2 x 2 at the start, text after), its
    patch embeddings and their rows; the enc-dec's frames [B, F, d]."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.mrope:
        t = np.arange(s)
        hw = np.stack([np.r_[[0, 0, 1, 1], t[4:] - 2], np.r_[[0, 1, 0, 1], t[4:] - 2]])
        pos = np.stack([np.r_[[0] * 4, t[4:] - 2], hw[0], hw[1]])
        batch["positions"] = np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32)
        batch["vision_embeds"] = rng.normal(0, 1, (b, 4, cfg.d_model)).astype(np.float32)
        batch["vision_pos"] = np.broadcast_to(np.arange(4), (b, 4)).astype(np.int32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (b, cfg.num_frames, cfg.d_model)
                                     ).astype(np.float32)
    return batch


#: the projections into attention scores: ``[L, d_in, heads, hd]`` leaves
QK_LEAVES = ("wq", "wk", "x_wq", "x_wk", "wq_b", "wkv_b")


def rescale_qk(tree):
    """``tree`` with every query/key projection (``QK_LEAVES``) scaled in
    place from the init's fan-in (the head count, ``shape[-2]``) to the
    ``d_in`` it contracts.  At the init's scale a score has std ~100s, so
    softmax is near argmax and float32 rounding noise in a score moves the
    output as a fault would (chip_smoke.py's ``rescale_qk`` says the same
    for the card); rescaled, scores have std ~1, as a trained model's do.
    Both packages get the same weights."""
    for k, v in tree.items():
        if isinstance(v, dict):
            rescale_qk(v)
        elif k in QK_LEAVES and v.ndim == 4:
            v *= np.float32((v.shape[-2] / v.shape[-3]) ** 0.5)
    return tree


def arch_params(jcfg, cfg, seed: int):
    """``(JAX params, the port's params)``: one numpy draw (query and key
    projections rescaled, ``rescale_qk``), converted."""
    tree = rescale_qk(np_spec_params(jax_steps.param_specs_for(jcfg), seed))
    to_port = (convert.encdec_params_from_numpy if cfg.family == "encdec"
               else convert.lm_params_from_numpy)
    return jax.tree.map(jnp.asarray, tree), to_port(tree, cfg, device="cpu")


def _cross_state(jcfg, jp, frames):
    """The JAX enc-dec serve state's cross K/V of ``frames``, as
    ``tests/test_models_correct.py`` builds them."""
    from repro.models import encdec as jax_ed

    enc_out = jax_ed.encode(jcfg, jp, frames)
    dec = jp["decoder"]
    return {n: jnp.stack([jax_common.dense(enc_out, dec[f"x_w{n}"][i])
                          for i in range(jcfg.dec_layers)]) for n in ("k", "v")}


def arch_parity(arch: str, *, factor: int = 8, b: int = 2, s: int = 16,
                n_steps: int = 8, seed: int = 0) -> None:
    """``arch`` through ``reduce_config(..., factor)`` in f32, on JAX's weights:
    the prefill step's last-position logits at the LM bar, then ``n_steps``
    greedy serve steps from an empty cache (the enc-dec's cross K/V from
    its encoder), each side feeding its own tokens, tokens equal."""
    jcfg, cfg = arch_configs(arch, factor)
    jp, p = arch_params(jcfg, cfg, seed)
    batch = arch_batch(cfg, b, s, seed + 1)
    want = jax.jit(jax_steps.make_prefill_step(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.make_prefill_step(cfg)(p, {k: _t(v) for k, v in batch.items()})
    assert got.shape == (b, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    jstate = jax.tree.map(lambda sp: jnp.zeros(sp.shape, jnp.float32),
                          jax_steps.state_specs_for(jcfg, b, n_steps),
                          is_leaf=lambda x: isinstance(x, jax_common.ParamSpec))
    state = init_params(steps.state_specs_for(cfg, b, n_steps), None,
                        torch.float32, "cpu")
    if cfg.family == "encdec":
        jstate["cross"] = _cross_state(jcfg, jp, jnp.asarray(batch["frames"]))
        state["cross"] = encdec.cross_kv(cfg, p, encdec.encode(
            cfg, p, _t(batch["frames"])))
        for n in ("k", "v"):
            np.testing.assert_allclose(state["cross"][n].numpy(),
                                       np.asarray(jstate["cross"][n]), **F32)
    jserve = jax.jit(jax_steps.make_serve_step(jcfg))
    serve_step = steps.make_serve_step(cfg)
    jtok = ttok = batch["tokens"][:, 0]
    for i in range(n_steps):
        jb = {"token": jnp.asarray(jtok)[:, None],
              "cache_len": jnp.full((b,), i, jnp.int32)}
        tb = {"token": _t(np.asarray(ttok))[:, None],
              "cache_len": torch.full((b,), i, dtype=torch.int32)}
        if cfg.mrope:
            jb["positions"] = jnp.full((3, b, 1), i, jnp.int32)
            tb["positions"] = torch.full((3, b, 1), i, dtype=torch.int32)
        jtok, jstate = jserve(jp, jstate, jb)
        ttok, state = serve_step(p, state, tb)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ["stablelm-3b", "command-r-plus-104b", "qwen2-vl-7b",
                                  "smollm-360m", "mamba2-370m", "zamba2-1.2b"])
def test_arch_prefill_and_greedy_serve_match_jax(arch):
    """Zamba2 at ``reduce_config(..., 4)``: at 8 its 4 layers make no group
    of 6 under the shared block, and the JAX package's hybrid decode then
    scans zero groups beside its LoRA stacks and raises."""
    arch_parity(arch, factor=4 if arch == "zamba2-1.2b" else 8)


def test_vlm_vision_rows_and_default_positions():
    """Qwen2-VL's patch embeddings replace the token rows at
    ``vision_pos``; with no positions the three M-RoPE streams are
    ``arange(S)``, as the batch would give them for text alone."""
    jcfg, cfg = arch_configs("qwen2-vl-7b")
    jp, p = arch_params(jcfg, cfg, 3)
    batch = arch_batch(cfg, 2, 12, 4)
    x = lm.embed_tokens(cfg, p, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_array_equal(x[:, :4].numpy(), batch["vision_embeds"])
    want = jax_lm.embed_tokens(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    toks = {"tokens": _t(batch["tokens"])}
    text = {**toks, "positions": torch.arange(12, dtype=torch.int32).expand(3, 2, 12)}
    np.testing.assert_array_equal(lm.forward(cfg, p, toks).numpy(),
                                  lm.forward(cfg, p, text).numpy())
