"""The port's SSM (Mamba2) and hybrid (Zamba2) serving paths against the
JAX package.

Same inputs, made from a seed with numpy, go through the JAX functions and
their counterparts in the port; JAX parameters are carried over with
``convert.lm_params_from_numpy``.  On the CPU the port's ``ssd_chunk``
runs its plain version; the JAX kernel runs in interpret mode.  The
reference init leaves ``A_log``, ``dt_bias``, the conv biases and
``shared_lora_b`` at 0, so the model tests overwrite them with seeded
nonzero values on both sides, which puts the dt bias, the decay rates and
the LoRA path under test.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.configs.base import param_count as jax_param_count  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_pallas  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mamba2 as jax_m2  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.models import lm, mamba2  # noqa: E402
from repro_torch.models.common import init_params, spec_leaves  # noqa: E402

#: the f32 bar of the LM checks
F32 = dict(rtol=1e-4, atol=1e-4)

#: the JAX SSD sweep (tests/test_kernels.py): (BC, Q, H, P, G, N)
SWEEP = [(2, 16, 2, 8, 1, 16), (3, 32, 4, 16, 2, 24), (1, 64, 8, 32, 4, 64)]

#: tiny SSM / hybrid configs: 2 Mamba2 groups of B/C, 4 heads, chunk 8
SSM = dict(name="t-ssm", family="ssm", attn_kind="none", num_layers=3,
           d_model=32, vocab=64, d_state=16, expand=2, ssm_headdim=16,
           ssm_ngroups=2, ssd_chunk=8, remat="none")
HYBRID = dict(name="t-hybrid", family="hybrid", num_layers=5, d_model=32,
              vocab=64, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
              d_state=16, expand=2, ssm_headdim=16, ssd_chunk=8,
              shared_attn_every=2, shared_attn_lora=8, remat="none")


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(seed, bc, q, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(rng.normal(0, 1, (bc, q, h, p))), f(rng.uniform(0.1, 0.9, (bc, q, h))),
            f(rng.normal(0, 0.3, (h,))), f(rng.normal(0, 1, (bc, q, g, n))),
            f(rng.normal(0, 1, (bc, q, g, n))), f(rng.normal(0, 1, (h,))))


# -- the kernel's plain version and ssd_chunked ---------------------------------


@pytest.mark.parametrize("bc,q,h,p,g,n", SWEEP)
def test_ssd_chunk_matches_pallas_sweep(bc, q, h, p, g, n):
    """The test_ssd_chunk_sweep shapes, at that sweep's tolerance, against
    the Pallas kernel (interpret mode) and the JAX plain version."""
    args = _ssd_inputs(bc + q + h, bc, q, h, p, g, n)
    ops.reset_launches()
    y, st = ops.ssd_chunk(*map(_t, args))
    assert ops.LAUNCHES["ssd_chunk"] == 0               # CPU: the plain version
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (bc, q, h, p) and st.shape == (bc, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    for want_y, want_st in (ssd_chunk_pallas(*jargs, interpret=True),
                            jax_ref.ssd_chunk_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=1e-4, atol=1e-4)


def test_ssd_chunk_ref_casts_model_dtype_operands():
    """``a_log``/``d_skip`` arrive in the model dtype: the plain version
    computes in f32 after the cast, as the kernel's wrapper does."""
    args = [_t(a) for a in _ssd_inputs(3, *SWEEP[1])]
    y32, st32 = ref.ssd_chunk_ref(*args)
    bf = torch.bfloat16  # tracecheck: disable=TC005 — model-dtype SSM parameters
    a_bf, d_bf = args[2].to(bf), args[5].to(bf)
    y, st = ref.ssd_chunk_ref(args[0], args[1], a_bf, args[3], args[4], d_bf)
    want_y, want_st = ref.ssd_chunk_ref(args[0], args[1], a_bf.float(), args[3],
                                        args[4], d_bf.float())
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert not torch.equal(y, y32)                       # the cast did round


@pytest.mark.parametrize("chunk,s", [(16, 64), (128, 100), (128, 200)],
                         ids=["4-chunks", "Q=100", "Q=200"])
def test_ssd_chunked_matches_jax(chunk, s):
    """The kernel (with D * x) plus the torch recurrence against the JAX
    ``ssd_chunked``, at the bar of the JAX kernel-plus-interchunk test."""
    rng = np.random.default_rng(chunk + s)
    bsz, h, p, g, n = 2, 4, 8, 2, 16
    f = lambda a: a.astype(np.float32)  # noqa: E731
    args = (f(rng.normal(0, 1, (bsz, s, h, p))), f(rng.uniform(0.1, 0.9, (bsz, s, h))),
            f(rng.normal(0, 0.3, (h,))), f(rng.normal(0, 1, (bsz, s, g, n))),
            f(rng.normal(0, 1, (bsz, s, g, n))), f(rng.normal(0, 1, (h,))))
    want = jax_m2.ssd_chunked(*map(jnp.asarray, args), chunk)
    got = mamba2.ssd_chunked(*map(_t, args), chunk)
    assert got.shape == (bsz, s, h, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)


def test_ssd_chunked_rejects_ragged_lengths():
    x = torch.zeros((1, 200, 2, 8))
    dt = torch.full((1, 200, 2), 0.5)
    bc = torch.zeros((1, 200, 1, 4))
    with pytest.raises(ValueError, match="chunks"):
        mamba2.ssd_chunked(x, dt, torch.zeros(2), bc, bc, torch.ones(2), 64)


# -- the Mamba2 block -------------------------------------------------------------


def _ssm_cfg():
    kw = dict(name="t", family="ssm", attn_kind="none", num_layers=1,
              d_model=32, vocab=64, d_state=16, expand=2, ssm_headdim=16,
              ssd_chunk=8)
    return JaxConfig(**kw).validate(), ModelConfig(**kw).validate()


def _seed_leaves(tree, rng):
    """Seeded nonzero values for the leaves the reference init leaves at
    0 or 1 (``A_log``, ``dt_bias``, ``D``, conv biases, ``shared_lora_b``)."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("A_log", "dt_bias"):
                out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == "D":
                out[k] = rng.normal(1, 0.3, v.shape).astype(np.float32)
            elif k.startswith("conv_") and k.endswith("_b"):
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "shared_lora_b":
                out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def _block_params(jcfg, seed):
    jp = jax_init_params(jax_m2.mamba2_specs(jcfg, 1), jax.random.PRNGKey(seed),
                         jnp.float32)
    tree = _seed_leaves(jax.tree.map(lambda t: np.asarray(t[0]), jp),
                        np.random.default_rng(seed))
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: _t(v) for k, v in tree.items()})


def test_mamba2_forward_and_decode_stream_match_jax():
    """The block on 16 tokens (2 chunks), then 16 one-token decode steps
    from a zero state: outputs and states at rtol 1e-4."""
    jcfg, cfg = _ssm_cfg()
    jp, p = _block_params(jcfg, seed=1)
    b, s = 2, 16
    x = np.random.default_rng(2).normal(0, 0.5, (b, s, cfg.d_model)).astype(np.float32)
    want = jax_m2.mamba2_forward(jp, jcfg, jnp.asarray(x))
    got = mamba2.mamba2_forward(p, cfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    jstate = jax_m2.mamba2_init_state(jcfg, b, jnp.float32)
    state = mamba2.mamba2_init_state(cfg, b, torch.float32, device="cpu")
    assert state["ssm"].dtype == torch.float32
    jdec = jax.jit(functools.partial(jax_m2.mamba2_decode, cfg=jcfg))
    for t in range(s):
        wy, jstate = jdec(jp, x=jnp.asarray(x[:, t:t + 1]), state=jstate)
        gy, state = mamba2.mamba2_decode(p, cfg, _t(x[:, t:t + 1]), state)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-5)
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_mamba2_decode_matches_forward():
    """The port's own check, at the JAX test's bar: stepping the recurrence
    token by token reproduces the chunked full-sequence forward."""
    _, cfg = _ssm_cfg()
    p = init_params(mamba2.mamba2_specs(cfg, 1), torch.Generator().manual_seed(1),
                    torch.float32, "cpu")
    p = {k: v[0] for k, v in p.items()}
    b, s = 2, 16
    x = torch.as_tensor(np.random.default_rng(3).normal(
        0, 0.5, (b, s, cfg.d_model)).astype(np.float32))
    full = mamba2.mamba2_forward(p, cfg, x)
    state = mamba2.mamba2_init_state(cfg, b, torch.float32, device="cpu")
    outs = []
    for t in range(s):
        y, state = mamba2.mamba2_decode(p, cfg, x[:, t:t + 1], state)
        outs.append(y[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


# -- the models -----------------------------------------------------------------


def _configs(kw, tied: bool):
    kw = dict(kw, tie_embeddings=tied, dtype="float32")
    return JaxConfig(**kw).validate(), ModelConfig(**kw).validate()


def _params(jcfg, cfg, seed):
    jp = jax_init_params(jax_lm.model_specs(jcfg), jax.random.PRNGKey(seed),
                         jnp.float32)
    tree = _seed_leaves(jax.tree.map(np.asarray, jp), np.random.default_rng(seed))
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params_from_numpy(tree, cfg, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(functools.partial(jax_lm.decode_step, jcfg))


MODELS = [(SSM, True), (SSM, False), (HYBRID, False)]
MODEL_IDS = ["ssm-tied", "ssm-untied", "hybrid"]


@pytest.mark.parametrize("kw,tied", MODELS, ids=MODEL_IDS)
def test_forward_and_prefill_match_jax(kw, tied):
    """24 tokens (3 chunks of 8): full logits and the prefill step's last
    position at the f32 bar."""
    jcfg, cfg = _configs(kw, tied)
    jp, p = _params(jcfg, cfg, seed=11 + tied)
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
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
    assert ops.LAUNCHES["ssd_chunk"] == 0                 # CPU: the plain version


@pytest.mark.parametrize("kw,tied", MODELS, ids=MODEL_IDS)
def test_decode_stream_matches_jax(kw, tied):
    """12 one-token steps from an empty state, each feeding the step's own
    greedy token: logits at the f32 bar, tokens equal, the states too."""
    jcfg, cfg = _configs(kw, tied)
    jp, p = _params(jcfg, cfg, seed=21 + tied)
    b, n = 3, 12
    jstate = jax.tree.map(jnp.zeros_like, jax_init_params(
        jax_lm.decode_state_specs(jcfg, b, n), jax.random.PRNGKey(0), jnp.float32))
    state = init_params(steps.state_specs_for(cfg, b, n), torch.Generator(),
                        torch.float32, "cpu")
    jtok = ttok = np.random.default_rng(22).integers(0, cfg.vocab, (b,)).astype(np.int32)
    serve_step = steps.make_serve_step(cfg)
    for i in range(n):
        jb = {"token": jnp.asarray(jtok)[:, None],
              "cache_len": jnp.full((b,), i, jnp.int32)}
        want, jstate = _jax_decode(jcfg)(jp, jstate, jb)
        tb = {"token": _t(ttok)[:, None],
              "cache_len": torch.full((b,), i, dtype=torch.int32)}
        got, _ = lm.decode_step(cfg, p, _clone(state), tb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        jtok = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        ttok, state = serve_step(p, state, tb)
        ttok = ttok.numpy()
        np.testing.assert_array_equal(ttok, jtok)
    want_leaves = {"/".join(k.key for k in path): np.asarray(v) for path, v in
                   jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got_leaves = dict(_flat(state))
    assert set(got_leaves) == set(want_leaves)
    for k, v in got_leaves.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want_leaves[k], **F32, err_msg=k)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _flat(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], path)
        else:
            yield path, tree[k]


def test_decode_state_pins_the_ssm_leaf_to_f32():
    cfg = reduce_config(get_config("zamba2-1.2b"), 4)
    specs = dict(spec_leaves(lm.decode_state_specs(cfg, 2, 16)))
    assert lm._hybrid_shape(cfg) == (1, 6, 3)
    for path, lead in (("groups", (1, 6)), ("tail", (3,))):
        assert specs[f"{path}/ssm"].dtype == "float32"
        assert specs[f"{path}/ssm"].shape == lead + (2, cfg.ssm_heads,
                                                     cfg.ssm_headdim, cfg.d_state)
        assert specs[f"{path}/conv_x"].dtype is None      # the model dtype
    assert specs["shared/k"].shape == (1, 2, 16, cfg.n_kv_heads, cfg.head_dim)
    state = init_params(lm.decode_state_specs(cfg, 2, 16), None,
                        getattr(torch, cfg.dtype), "cpu")
    assert state["groups"]["ssm"].dtype == torch.float32
    assert state["groups"]["conv_x"].dtype == getattr(torch, cfg.dtype)


# -- configs, counts, the launcher -------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_config_specs_and_count_match_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jax_lm.model_specs(jcfg),
        is_leaf=lambda x: type(x).__name__ == "ParamSpec")[0]
    want = {"/".join(k.key for k in path): (s.shape, s.axes, s.init, s.scale, s.dtype)
            for path, s in jleaves}
    got = {path: (s.shape, s.axes, s.init, s.scale, s.dtype)
           for path, s in spec_leaves(lm.model_specs(cfg))}
    assert got == want
    assert lm.count_params_analytic(cfg) == jax_param_count(jcfg)
    for factor in (1, 4, 8):
        assert dataclasses.asdict(reduce_config(cfg, factor)) == \
            dataclasses.asdict(jax_reduce_config(jcfg, factor))


def test_published_shapes():
    m, z = get_config("mamba2-370m"), get_config("zamba2-1.2b")
    assert (m.num_layers, m.d_model, m.d_inner, m.ssm_heads, m.ssm_headdim,
            m.d_state, m.ssm_ngroups, m.vocab, m.tie_embeddings, m.ssd_chunk) == (
        48, 1024, 2048, 32, 64, 128, 1, 50280, True, 128)
    assert (z.num_layers, z.d_model, z.ssm_heads, z.d_state, z.n_heads,
            z.n_kv_heads, z.d_ff, z.shared_attn_every, z.shared_attn_lora,
            z.vocab) == (38, 2048, 64, 64, 32, 32, 8192, 6, 128, 32000)
    assert lm._hybrid_shape(z) == (6, 6, 2)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_serve_main_end_to_end_on_cpu(arch):
    argv = ["--arch", arch, "--device", "cpu", "--reduce", "8", "--batch", "2",
            "--prompt-len", "5", "--gen", "6", "--seed", "4"]
    res = serve.main(argv)
    assert res.cfg == reduce_config(get_config(arch), 8)
    assert res.tokens.shape == (2, 6) and res.tokens.dtype == torch.int32
    assert bool(((res.tokens >= 0) & (res.tokens < res.cfg.vocab)).all())
    assert torch.equal(serve.main(argv).tokens, res.tokens)      # seeded
