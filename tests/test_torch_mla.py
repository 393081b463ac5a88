"""The port's Multi-head Latent Attention against the JAX package.

Same inputs, made from a seed with numpy, go through ``repro.models.mla``
and ``repro_torch.models.mla`` in float32 on the CPU: the flash kernel's
plain version at distinct QK / V head dims (against the JAX package's
chunked XLA route: its Pallas kernel takes one head dim), the prefill by
latent expansion (with and without the q LoRA), the absorbed decode
against the latent cache step by step, and MiniCPM3-4B end to end through
``reduce_config(..., 8)``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, mla  # noqa: E402
from test_torch_lm import arch_parity, np_spec_params, rescale_qk  # noqa: E402

#: the f32 bar of the attention sweep (tests/test_torch_kernels.py)
FLASH_F32 = dict(rtol=2e-5, atol=2e-4)
#: the f32 bar of MLA
MLA_F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two CPU threads for the port's ops in this module (the suite runs in
    several processes at once); the count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(96, 64), (192, 128), (80, 80), (24, 16)])
def test_flash_distinct_head_dims_match_jax_chunked(d, dv, causal):
    """``ops.flash_attention`` on the CPU (the kernel's plain version) at
    the MLA pairs of MiniCPM3 and DeepSeek-V2-Lite, StableLM's 80 and a
    small pair, GQA, ragged, against the JAX package's chunked attention
    on its XLA route, in the JAX layout, with MLA's own scale."""
    rng = np.random.default_rng(d + dv + causal)
    q = rng.normal(0, 1, (2, 40, 4, d)).astype(np.float32)
    k = rng.normal(0, 1, (2, 64, 2, d)).astype(np.float32)
    v = rng.normal(0, 1, (2, 64, 2, dv)).astype(np.float32)
    scale = 0.7 * d ** -0.5
    want = jax_attention.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                           kv_chunk=16, scale=scale)
    got = ops.flash_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                              causal=causal, scale=scale).transpose(1, 2)
    assert got.shape == (2, 40, 4, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_F32)
    via = attention.chunked_attention(*map(_t, (q, k, v)), causal=causal,
                                      kv_chunk=16, scale=scale)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


def _configs(q_lora: int):
    kw = dict(name="t", family="dense", num_layers=2, d_model=48, vocab=64,
              n_heads=4, n_kv_heads=4, head_dim=24, attn_kind="mla",
              q_lora=q_lora, kv_lora=24, qk_nope_dim=16, qk_rope_dim=8,
              v_head_dim=12, d_ff=96, remat="none")
    return JaxConfig(**kw).validate(), ModelConfig(**kw).validate()


def _layer(jcfg, seed):
    """One MLA layer's parameters (numpy, the JAX init's law, queries and
    keys rescaled), unstacked."""
    tree = rescale_qk(np_spec_params(jax_mla.mla_specs(jcfg, 1), seed))
    return {k: v[0] for k, v in tree.items()}


@pytest.mark.parametrize("q_lora", [0, 20], ids=["direct_q", "q_lora"])
def test_mla_prefill_matches_jax(q_lora):
    jcfg, cfg = _configs(q_lora)
    p = _layer(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 11, 48)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11) + 5, (2, 11)).astype(np.int32)
    want = jax_mla.mla_prefill({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                               jnp.asarray(x), jnp.asarray(pos), kv_chunk=8)
    got = mla.mla_prefill({k: _t(v) for k, v in p.items()}, cfg, _t(x), _t(pos),
                          kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLA_F32)


@pytest.mark.parametrize("q_lora", [0, 20], ids=["direct_q", "q_lora"])
def test_mla_decode_matches_jax(q_lora):
    """Ten absorbed decode steps into an 12-slot latent cache (two rows at
    other lengths), each output at the f32 bar, the caches written in
    place equal to the JAX package's returned ones."""
    jcfg, cfg = _configs(q_lora)
    p = _layer(jcfg, 5)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    b, t = 2, 12
    jcache = {"c_kv": jnp.zeros((b, t, 24)), "k_rope": jnp.zeros((b, t, 8))}
    cache = {"c_kv": torch.zeros((b, t, 24)), "k_rope": torch.zeros((b, t, 8))}
    step = jax.jit(lambda p, x, c, pos, cl: jax_mla.mla_decode(p, jcfg, x, c, pos, cl))
    for i in range(10):
        x = rng.normal(0, 1, (b, 1, 48)).astype(np.float32)
        cl = np.array([i, i + 2], np.int32)
        want, jcache = step(jp, jnp.asarray(x), jcache, jnp.asarray(cl[:, None]),
                            jnp.asarray(cl))
        got, out = mla.mla_decode(tp, cfg, _t(x), cache, _t(cl[:, None]), _t(cl))
        assert out["c_kv"] is cache["c_kv"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLA_F32)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **MLA_F32)


def test_mla_specs_match_jax():
    for q_lora in (0, 20):
        jcfg, cfg = _configs(q_lora)
        want = jax_mla.mla_specs(jcfg, 3)
        got = mla.mla_specs(cfg, 3)
        assert {k: (s.shape, s.axes, s.init, s.scale) for k, s in got.items()} == \
            {k: (s.shape, s.axes, s.init, s.scale) for k, s in want.items()}


def test_minicpm3_prefill_and_greedy_serve_match_jax():
    arch_parity("minicpm3-4b")
