"""The port's encoder-decoder backbone against the JAX package.

Same inputs, made from a seed with numpy, go through ``repro.models.encdec``
and ``repro_torch.models.encdec`` in float32 on the CPU: the bidirectional
encoder over stub frame embeddings, the teacher-forced decoder with its
cross-attention, the serve state's cross K/V, the one-token decode step
against the self cache and the cross K/V, and Seamless-M4T medium end to
end through ``reduce_config(..., 8)``.  JAX parameters are carried over
with ``convert.encdec_params_from_numpy``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import encdec as jax_ed  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.common import init_params, spec_leaves  # noqa: E402
from test_torch_lm import arch_parity, np_spec_params, rescale_qk  # noqa: E402

#: the f32 bar of the LM checks
F32 = dict(rtol=1e-4, atol=1e-4)

KW = dict(name="t", family="encdec", num_layers=0, d_model=48, vocab=80,
          n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96, enc_layers=2,
          dec_layers=2, num_frames=8, remat="none", dtype="float32")


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


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = JaxConfig(**KW).validate(), ModelConfig(**KW).validate()
    tree = rescale_qk(np_spec_params(jax_ed.encdec_specs(jcfg), 3))
    jp = jax.tree.map(jnp.asarray, tree)
    p = convert.encdec_params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(4)
    frames = rng.normal(0, 0.3, (2, 8, 48)).astype(np.float32)
    tokens = rng.integers(0, 80, (2, 10)).astype(np.int32)
    return jcfg, cfg, jp, p, frames, tokens


def test_encode_and_decode_train_match_jax():
    jcfg, cfg, jp, p, frames, tokens = _setup()
    want_enc = jax_ed.encode(jcfg, jp, jnp.asarray(frames))
    enc = encdec.encode(cfg, p, _t(frames))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), **F32)
    want = jax_ed.decode_train(jcfg, jp, jnp.asarray(tokens), want_enc)
    got = encdec.decode_train(cfg, p, _t(tokens), enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_steps_match_jax_and_the_teacher_forced_decoder():
    """Ten decode steps against a zero self cache and the encoder's cross
    K/V (``cross_kv``, held against the JAX package's stack of
    ``x_wk``/``x_wv`` products): logits at the f32 bar against JAX's
    steps and against the teacher-forced decoder's."""
    jcfg, cfg, jp, p, frames, tokens = _setup()
    b, s = tokens.shape
    want_enc = jax_ed.encode(jcfg, jp, jnp.asarray(frames))
    jstate = jax.tree.map(lambda sp: jnp.zeros(sp.shape, jnp.float32),
                          jax_ed.encdec_state_specs(jcfg, b, s),
                          is_leaf=lambda x: isinstance(x, jax_common.ParamSpec))
    jstate["cross"] = {n: jnp.stack([jax_common.dense(want_enc, jp["decoder"][f"x_w{n}"][i])
                                     for i in range(2)]) for n in ("k", "v")}
    enc = encdec.encode(cfg, p, _t(frames))
    state = init_params(encdec.encdec_state_specs(cfg, b, s), None, torch.float32, "cpu")
    state["cross"] = encdec.cross_kv(cfg, p, enc)
    for n in ("k", "v"):
        assert state["cross"][n].shape == (2, b, 8, 2, 12)
        np.testing.assert_allclose(state["cross"][n].numpy(),
                                   np.asarray(jstate["cross"][n]), **F32)
    teacher = jax_common.dense(jax_ed.decode_train(jcfg, jp, jnp.asarray(tokens), want_enc),
                               jp["unembed"])
    step = jax.jit(functools.partial(jax_ed.encdec_decode_step, jcfg))
    for i in range(s):
        cl = np.full((b,), i, np.int32)
        want, jstate = step(jp, jstate, {"token": jnp.asarray(tokens[:, i:i + 1]),
                                         "cache_len": jnp.asarray(cl)})
        got, state = encdec.encdec_decode_step(cfg, p, state, {
            "token": _t(tokens[:, i:i + 1]), "cache_len": _t(cl)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(teacher[:, i]),
                                   rtol=2e-3, atol=2e-3)
    for n in ("k", "v"):
        np.testing.assert_allclose(state["self"][n].numpy(),
                                   np.asarray(jstate["self"][n]), **F32)


def test_prefill_step_matches_jax():
    """``make_prefill_step`` of the enc-dec family: the encoder, the decoder
    and the last position's logits."""
    from repro.launch import steps as jax_steps

    jcfg, cfg, jp, p, frames, tokens = _setup()
    want = jax_steps.make_prefill_step(jcfg)(jp, {"frames": jnp.asarray(frames),
                                                  "tokens": jnp.asarray(tokens)})
    got = steps.make_prefill_step(cfg)(p, {"frames": _t(frames), "tokens": _t(tokens)})
    assert got.shape == (2, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_specs_and_conversion_match_jax():
    jcfg, cfg, *_ = _setup()
    flat = jax.tree_util.tree_flatten_with_path(
        jax_ed.encdec_specs(jcfg), is_leaf=lambda x: isinstance(x, jax_common.ParamSpec))[0]
    want = {"/".join(k.key for k in path): (s.shape, s.axes, s.init, s.scale)
            for path, s in flat}
    assert {path: (s.shape, s.axes, s.init, s.scale)
            for path, s in spec_leaves(encdec.encdec_specs(cfg))} == want
    tree = np_spec_params(jax_ed.encdec_specs(jcfg), 1)
    bad = dict(tree, decoder=dict(tree["decoder"], x_wq=tree["decoder"]["x_wq"][:1]))
    with pytest.raises(ValueError, match="decoder/x_wq"):
        convert.encdec_params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(KeyError, match="encoder"):
        convert.encdec_params_from_numpy({k: v for k, v in tree.items() if k != "encoder"},
                                         cfg, device="cpu")


def test_seamless_prefill_and_greedy_serve_match_jax():
    arch_parity("seamless-m4t-medium")
